"""Inputs shared by the port's CPU tests and its tests on the card
(numpy only: tests/test_torch_gpu.py runs where jax is not installed).
"""

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)

# ----------------------------------------------------------------------
# the delta rebuild's odd cases


def random_delta_batch(seed: int, B: int, E: int, L: int, marker_p=0.2,
                       ascending=True, pos_dtype=np.uint16):
    """(pos (B, E), val (B, E), base (L,)): unique random positions, a
    random share of padding slots (pos = L + slot), codes and run
    markers drawn independently, so starts nest, ends come first, runs
    stay open and plain codes fall inside runs.  Every fourth row has
    no marker, every eighth no entry.  `ascending` orders a row as the
    encoder does (real entries ascending, then the padding); otherwise
    its slots are shuffled."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 16, L).astype(np.uint8)
    pos = np.empty((B, E), np.int64)
    val = np.empty((B, E), np.uint8)
    for b in range(B):
        n_real = 0 if b % 8 == 7 else int(rng.integers(1, min(E, L) + 1))
        p = np.sort(rng.choice(L, n_real, replace=False))
        v = rng.integers(0, 16, n_real)
        if b % 4 != 3:
            m = rng.random(n_real) < marker_p
            v[m] = np.where(rng.random(int(m.sum())) < 0.5, 16,
                            32 + rng.integers(0, 16, int(m.sum())))
        pos[b] = np.concatenate([p, L + np.arange(n_real, E)])
        val[b] = np.concatenate([v, np.zeros(E - n_real, np.int64)])
        if not ascending:
            order = np.random.default_rng([seed, b]).permutation(E)
            pos[b], val[b] = pos[b, order], val[b, order]
    return pos.astype(pos_dtype), val, base


def named_delta_rows(L: int = 200):
    """One row a named odd case, entries ascending: {name: row index},
    pos (B, 8) uint16, val, base, and the expected rows."""
    base = (np.arange(L) % 15 + 1).astype(np.uint8)       # no zero site
    rows = {
        "inner_code": [(10, 16), (20, 7), (30, 32 + 5)],
        "nested_start": [(10, 16), (15, 16), (40, 32 + 3), (60, 32 + 9)],
        "open_run": [(5, 3), (150, 16)],
        "end_first": [(10, 32 + 4), (20, 16), (30, 16), (50, 32 + 1)],
        "adjacent": [(0, 16), (1, 32 + 2), (2, 16), (L - 1, 32 + 6)],
        "codes_only": [(0, 0), (7, 15), (L - 1, 9)],
        "empty": [],
        "run_of_one_row": [(0, 16)],
    }
    E = 8
    pos = np.tile(L + np.arange(E), (len(rows), 1)).astype(np.uint16)
    val = np.zeros((len(rows), E), np.uint8)
    want = np.tile(base, (len(rows), 1))
    for b, entries in enumerate(rows.values()):
        for k, (p, v) in enumerate(entries):
            pos[b, k], val[b, k] = p, v
    w = want
    n = {name: b for b, name in enumerate(rows)}
    w[n["inner_code"], 10:30] = 0
    w[n["inner_code"], 30] = 5
    w[n["nested_start"], 10:60] = 0          # the first end leaves sum 1
    w[n["nested_start"], 60] = 9
    w[n["open_run"], 5] = 3
    w[n["open_run"], 150:] = 0
    w[n["end_first"], 10] = 4                # sum -1, then 0: not inside
    w[n["end_first"], 20] = 0
    w[n["end_first"], 30:50] = 0             # sum 1 from the second start
    w[n["end_first"], 50] = 1
    w[n["adjacent"], 0] = 0
    w[n["adjacent"], 1] = 2
    w[n["adjacent"], 2:L - 1] = 0
    w[n["adjacent"], L - 1] = 6
    w[n["codes_only"], [0, 7, L - 1]] = [0, 15, 9]
    w[n["run_of_one_row"], :] = 0
    return n, pos, val, base, want


# ----------------------------------------------------------------------
# gap runs for the align walks


def gap_case(name: str, seed: int = 11):
    """ref (n,), q (1, m_pad), qlen (1,), lo, W: one query whose path
    holds the named gap run, longer than the walks' probe."""
    rng = np.random.default_rng(seed)
    n = 260
    ref = ACGT[rng.integers(0, 4, n)]
    ins = bytes(ACGT[rng.integers(0, 4, 75)])
    r = ref.tobytes()
    lo, W = -100, 201
    if name == "truncated_start":          # leading deletions (column 0)
        q = r[70:]
    elif name == "truncated_end":          # an X run from the last row
        q = r[:n - 70]
    elif name == "truncated_both":
        q = r[30:n - 41]
    elif name == "long_x":                 # a deletion inside
        q = r[:100] + r[171:]
    elif name == "long_y":                 # an insertion inside
        q = r[:120] + ins + r[120:]
    elif name == "leading_insertion":      # row 0, i == 0
        q = ins + r
    elif name == "trailing_insertion":     # a Y run from the last cell
        q = r + ins
    elif name == "x_then_y":               # a deletion next to an insertion
        q = r[:90] + ins[:40] + r[150:]
    elif name == "band_edge_x":            # the deletion runs to slot W-1
        q, lo, W = r[:100] + r[140:], -40, 41
    elif name == "band_edge_y":            # the insertion runs to slot 0
        q, lo, W = r[:100] + ins[:38] + r[100:], 0, 39
    elif name == "outside_band":           # the band cannot hold the path
        q, lo, W = r[:100] + r[171:], -8, 17
    else:
        raise AssertionError(name)
    arr = np.zeros((1, len(q) + 9), np.uint8)
    arr[0, :len(q)] = np.frombuffer(q, np.uint8)
    return ref, arr, np.array([len(q)], np.int32), lo, W


GAP_CASES = ["truncated_start", "truncated_end", "truncated_both", "long_x",
             "long_y", "leading_insertion", "trailing_insertion", "x_then_y",
             "band_edge_x", "band_edge_y", "outside_band"]
