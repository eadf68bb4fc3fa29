"""Pre-render adversarial sequences into the npz cache (host numpy only);
the port's copy of scripts/render_cache.py.

Rendering costs ~0.2 s/frame at QVGA on the host (4x that at VGA);
accuracy runs hit the cache ($SF_ADV_CACHE, default /tmp/sf_adv_cache),
so they pay only the SLAM run.  The file names are the generator's cache
keys, the same as the JAX generator's:

  python -m staticfusion_tpu_torch.apps.render_cache profile:frames:seed[:res_factor] ...
"""

import argparse
import time

from staticfusion_tpu_torch.apps.accuracy_bench import cache_dir
from staticfusion_tpu_torch.config import CameraConfig, SFConfig
from staticfusion_tpu_torch.io import adversarial as adv


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("specs", nargs="+",
                    help="profile:frames:seed[:res_factor] (res_factor 2 = "
                         "QVGA, 1 = VGA)")
    args = ap.parse_args(argv)
    cache = cache_dir()
    for spec in args.specs:
        parts = spec.split(":")
        profile, n, seed = parts[0], int(parts[1]), int(parts[2])
        rf = int(parts[3]) if len(parts) > 3 else 2
        cfg = SFConfig(camera=CameraConfig(width=640 // rf, height=480 // rf))
        t0 = time.time()
        adv.make_adversarial_sequence(cfg, n, profile, seed=seed,
                                      cache_dir=cache)
        print(f"{spec}: {time.time() - t0:.0f}s", flush=True)


if __name__ == "__main__":
    main()
