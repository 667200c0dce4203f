"""krylov_iters: the Krylov iterations of a solve, summed over all its
Krylov solves (the primary solve, its defect-correction solves, the tet
path's face-to-vertex projection), averaged over the solves read, from
``last_stats``."""

KEYS = ("iters", "proj_iters")
LISTS = ("correction_iters",)


def read(run):
    per = []
    for s in run.window_stats:
        n = sum(int(s[k]) for k in KEYS if k in s)
        n += sum(sum(int(x) for x in s.get(k, ())) for k in LISTS)
        per.append(n)
    return sum(per) / len(per) if per else None
