"""Work completed per second: the units of the completed jobs (the
driver's count: genomes streamed, queries read) over the time from the
window's start to the end of the last completed job (the window's jobs
alone: a traced run's profiled job comes after it)."""


def read(run, spec):
    done = [j for j in run.window_jobs if j["rc"] == 0]
    if not done:
        return None
    return sum(j["units"] for j in done) / (done[-1]["t1"] - run.window[0])
