"""mem_peak_gb: the most device memory allocated during any solve of the
window, in GB (1e9 bytes).  The program resets the peak at each call, so
the harness reads ``torch.cuda.max_memory_allocated()`` after every solve:
the persistent factor, the graph pools and the transients."""


def read(run):
    return max(run.mem_peaks) / 1e9 if run.mem_peaks else None
