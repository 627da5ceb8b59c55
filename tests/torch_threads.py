"""The port's CPU tests run PyTorch on one intra-op thread.

The suite runs in several worker processes on one machine
(pytest-xdist).  A PyTorch op on the CPU otherwise fans out over every
core, and in loops of small ops (the kernels' emulated schedules, the
plain versions' steps a diagonal, a level or a batch) each op then waits
on threads that the other workers' threads have descheduled: such tests
ran several times slower at eight threads than at one, 6 workers on 8
cores.  Every port test module imports this module; the setting is
process-wide.
"""

import torch

torch.set_num_threads(1)
