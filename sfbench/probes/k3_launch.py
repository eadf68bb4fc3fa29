"""K3's launches: the pixels of each solve and, after the window, the
IRLS iterations it ran (the launch's OUT_ITERS slot, named by the
program's own constant)."""

TARGET = "staticfusion_tpu_torch.kernels.irls:irls_solve_flat"


def record(args, kwargs, result):
    return {"n": int(args[0].B_c.shape[0]), "out": result}


def finish(records, module):
    slot = getattr(module, "OUT_ITERS", None)
    if slot is None:
        return []
    return [{"n": r["n"], "iterations": int(r["out"][slot])} for r in records]
