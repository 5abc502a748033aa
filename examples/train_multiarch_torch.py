"""End-to-end training driver across the architecture zoo, on the PyTorch
port.

Runs a short training job (reduced config) for any or all of the ten
architectures through the real launcher path (``launch/train.py``: the
optimizer, gradient clipping, forecast heads and frontend prefixes where
configured, checkpointing), then asserts its exactness claim: every
logged loss is finite, and the checkpoint the launcher wrote in the
reference's format (``--ckpt-dir``) restores the trained parameters bit
for bit. The port of ``examples/train_multiarch.py``.

    PYTHONPATH=src python examples/train_multiarch_torch.py --arch rwkv6-7b
    PYTHONPATH=src python examples/train_multiarch_torch.py --all --steps 20
"""
import argparse
import math
import tempfile

import torch

from repro_torch.checkpoint.io import load_pytree, params_from_numpy
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.device import resolve_device
from repro_torch.launch.train import main as train_main
from repro_torch.optim.optimizers import tree_leaves


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    targets = list(ARCHS) if args.all else [args.arch]
    for arch in targets:
        print(f"=== {arch} (reduced) on {dev} ===")
        with tempfile.TemporaryDirectory() as ckpt:
            params, logged = train_main(
                ["--arch", arch, "--reduced", "--steps", str(args.steps),
                 "--batch", "4", "--seq", "64", "--log-every",
                 str(args.log_every), "--ckpt-dir", ckpt, "--ckpt-every",
                 str(args.steps), "--device", str(dev)])
            assert logged and all(math.isfinite(l) for _, l in logged), (
                arch, logged)
            back = params_from_numpy(load_pytree(ckpt, args.steps),
                                     get_config(arch, reduced=True), dev)
        same = all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                      tree_leaves(back)))
        print(f"{arch}: losses {[round(l, 4) for _, l in logged]}, all "
              f"finite; checkpoint restores bitwise: {same}")
        assert same, f"{arch}: the checkpoint does not restore bitwise"


if __name__ == "__main__":
    main()
