"""Tensor ops: attention kernels and their plain versions, KV cache, pruning."""

import torch

# The first torch.exp of a process on the CPU, where torch splits it over
# threads, now and then came out up to 1.5e-4 (relative) off in one
# thread's chunk on a loaded machine, while every later call was exact
# (ROADMAP C25: the plain attention versions' softmax): the vector math
# library sets itself up at its first call, and two threads entered it at
# once. One call below the split size, on this thread, sets it up first.
torch.exp(torch.zeros(64))
