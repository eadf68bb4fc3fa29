"""Command-line entry points of the port: run_sequence, run_tum and
make_synthetic_dataset (python -m staticfusion_tpu_torch.apps.<name>)."""
