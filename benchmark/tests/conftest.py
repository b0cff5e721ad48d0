"""The benchmark's tests run the tiny cells on the CPU, often in several
worker processes at once: each keeps to two of torch's threads, so that
the workers do not crowd the host's cores."""
import torch

torch.set_num_threads(2)
