"""Multi-process runs and device meshes (the port of ``pctpu.parallel``).

The reference is one process on one thread.  pctpu scales a dataset run two
ways, and the port keeps both: several processes each take a strided slice
of the file or pair list (``distributed``), and one process splits a batch
over a ``(data, points)`` mesh of devices (``mesh``).  No tensor crosses
processes: a process group carries identity and a barrier only.
"""
