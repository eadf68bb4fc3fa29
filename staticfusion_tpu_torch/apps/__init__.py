"""Command-line entry points of the port (python -m
staticfusion_tpu_torch.apps.<name>): run_sequence, run_tum, run_camera,
run_multihost and make_synthetic_dataset, and the evaluation tools
accuracy_bench, r5_suite, check_closures, seg_diag, render_cache,
calibrate_loop, stream_feed and smoke_e2e."""
