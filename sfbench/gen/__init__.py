"""Traffic generation: the adversarial RGB-D sequences, rendered on the
card from the seed (adversarial.py)."""
