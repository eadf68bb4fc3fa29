"""The benchmark's reference: a frozen plain-PyTorch copy of the port's
per-frame step (sf/) and the comparison that decides a run's `correct`
(compare.py).  Nothing here imports the port or JAX."""
