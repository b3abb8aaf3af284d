"""Operations and bytes of each hand-written kernel, one file per kernel
(``<kernel>.py``), and the table of device peaks (``peaks.py``).

Each kernel file gives ``flops`` and ``bytes_moved`` of one launch, counted
from what its inputs need, and ``bound_s``: the least time the device could
take, the larger of operations over the float32 peak and bytes over the
memory bandwidth.
"""
