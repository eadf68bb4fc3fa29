"""K1's launches: the rows and columns of each frame it preprocessed."""

TARGET = "staticfusion_tpu_torch.kernels.bilateral:preprocess_depth_cuda"


def record(args, kwargs, result):
    rows, cols = args[0].shape
    return {"rows": int(rows), "cols": int(cols)}


def finish(records, module):
    return list(records)
