"""precompute_s: the cold solve's host precompute, the phases of
``last_stats["phases"]`` whose name holds "precompute" (the grid's sources,
grid, constraint rows and Gram tables; the tet mesher, the FEM operators
and the AMG set-up).  Each phase ends in a device sync, so the span holds
the device upload it queues too."""


def read(run):
    phases = run.cold_stats.get("phases", {})
    spans = [v for k, v in phases.items() if "precompute" in k]
    return sum(spans) if spans else None
