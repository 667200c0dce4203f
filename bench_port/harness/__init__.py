"""The benchmark's harness: the manifest and the files it names
(``manifest``), the guard against JAX and the JAX package (``guard``), the
device's name and peaks (``device``) and the reduction of a profiler trace
to intervals, shares and a breakdown (``trace``)."""
