"""Percent from a count that the program logs each job: the lines that
match spec['pattern'], summed over the window's jobs, numerator over denominator,
each a signed sum of the pattern's groups (spec['numerator'],
spec['denominator']: lists of group numbers, negative to subtract)."""

import re


def read(run, spec):
    pat = re.compile(spec["pattern"])
    num = den = 0
    for job in run.window_jobs:
        for m in pat.finditer(job.get("log", "")):
            g = [0] + [int(x) for x in m.groups()]
            num += sum(g[i] if i > 0 else -g[-i] for i in spec["numerator"])
            den += sum(g[i] if i > 0 else -g[-i]
                       for i in spec["denominator"])
    return 100.0 * num / den if den else None
