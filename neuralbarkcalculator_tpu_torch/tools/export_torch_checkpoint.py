"""Export the JAX package's trained weights to the reference's
``best_model.pt`` format, on a machine without jax, flax or orbax (the
JAX package's ``tools/export_torch_checkpoint.py``).

Takes an orbax ``best_model`` directory (or a per-epoch checkpoint) or a
flax ``.msgpack`` file of ``fcn_resnet50`` and writes the torchvision-named
state dict that the reference's ``fcn_resnet50().load_state_dict`` and the
port's ``--model_path`` accept::

    python -m neuralbarkcalculator_tpu_torch.tools.export_torch_checkpoint \\
        CKPT_PATH OUT.pt
"""
from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("ckpt", help="orbax dir or flax .msgpack")
    parser.add_argument("out", help="output .pt path")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    import torch

    from ..models.convert import load_jax_checkpoint

    state = load_jax_checkpoint(args.ckpt, "fcn_resnet50")
    torch.save({k: v.contiguous() for k, v in state.items()}, args.out)
    print(f"wrote {args.out} ({len(state)} tensors)")


if __name__ == "__main__":
    main()
