"""Host-side converter: reference HDF5 banks and flax msgpack params to .npz.

A CUDA machine that runs the port may have neither h5py nor msgpack, so
what it reads is converted here, on a host that has them:

    python -m rbc_gym_tpu_torch.utils.convert bank IN.h5 OUT.npz
    python -m rbc_gym_tpu_torch.utils.convert params IN.msgpack OUT.npz
    python -m rbc_gym_tpu_torch.utils.convert assets

``assets`` regenerates the files committed under ``rbc_gym_tpu_torch/assets/``
from the repo's ``data/checkpoints/`` and ``results/`` (``ASSETS``).

A params ``.npz`` holds one array per leaf of the flax tree, keyed by its
path (``params/Conv_0/kernel``, ...), in flax's layout; ``models.params``
maps it onto a torch module. flax itself is not used, since it imports jax:
``read_flax_msgpack`` decodes flax's msgpack format (ndarrays as msgpack
extension type 1 holding ``(shape, dtype name, C-order bytes)``, numpy
scalars as type 3) with msgpack alone.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path
from typing import Dict

import numpy as np

from rbc_gym_tpu_torch.utils import checkpoints as ckpt

REPO = Path(__file__).resolve().parents[2]
ASSET_DIR = Path(__file__).resolve().parents[1] / "assets"
# committed asset -> its source in the repo
ASSETS = {
    "ckpt_ra10000_train.npz": "data/checkpoints/train/ckpt_ra10000.h5",
    "ckpt_ra10000_test.npz": "data/checkpoints/test/ckpt_ra10000.h5",
    "sarl2d_ra10000_best_model.npz": "results/sarl2d_ra10000/models/best_model.msgpack",
    "3D_ckpt_ra2500_train.npz": "data/checkpoints/train/3D_ckpt_ra2500.h5",
    "3D_ckpt_ra2500_test.npz": "data/checkpoints/test/3D_ckpt_ra2500.h5",
    "sarl_ra2500_best_model.npz": "results/sarl_ra2500/models/best_model.msgpack",
    "ckpt_ra30000_train.npz": "data/checkpoints/train/ckpt_ra30000.h5",
}

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


def _decode_ndarray(msgpack, data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(shape).copy()


def read_flax_msgpack(path) -> Dict[str, np.ndarray]:
    """A flax ``serialization.to_bytes`` file -> {"a/b/c": array}."""
    import msgpack

    def ext_hook(code, data):
        if code == _EXT_NDARRAY:
            return _decode_ndarray(msgpack, data)
        if code == _EXT_NPSCALAR:
            return _decode_ndarray(msgpack, data)[()]
        raise ValueError(f"{path}: msgpack extension type {code} is not a flax array")

    with open(path, "rb") as f:
        tree = msgpack.unpackb(f.read(), ext_hook=ext_hook, raw=False)
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for k, v in node.items():
            name = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, dict):
                if "__msgpack_chunked_array__" in v:
                    raise ValueError(f"{path}: chunked array at {name} is not supported")
                walk(v, name)
            else:
                flat[name] = np.asarray(v)

    walk(tree, "")
    return flat


def _narrowed(bank):
    """``bank`` with each field as float32 where that loses nothing (the
    repo's banks hold float32 values stored as float64)."""
    for f in dataclasses.fields(bank):
        a = getattr(bank, f.name)
        if isinstance(a, np.ndarray) and np.array_equal(a, a.astype(np.float32)):
            setattr(bank, f.name, a.astype(np.float32))
    return bank


def convert_bank(src, dst) -> None:
    """Reference HDF5 bank -> .npz, float32 where lossless; 2D when the
    file's y axis has one point."""
    with ckpt._h5py().File(src, "r") as f:
        three_d = f["b"].shape[1] != 1  # h5py view (nz, 1 or ny, nx, E)
    if three_d:
        ckpt.save_bank_3d(dst, _narrowed(ckpt.load_bank_3d(src)))
    else:
        ckpt.save_bank_2d(dst, _narrowed(ckpt.load_bank_2d(src)))


def convert_params(src, dst) -> None:
    np.savez(dst, **read_flax_msgpack(src))


def convert(src, dst) -> None:
    (convert_params if str(src).endswith(".msgpack") else convert_bank)(src, dst)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m rbc_gym_tpu_torch.utils.convert",
                                description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    for name in ("bank", "params"):
        s = sub.add_parser(name)
        s.add_argument("src")
        s.add_argument("dst")
    sub.add_parser("assets")
    args = p.parse_args(argv)
    if args.cmd == "assets":
        ASSET_DIR.mkdir(exist_ok=True)
        for name, src in ASSETS.items():
            convert(REPO / src, ASSET_DIR / name)
            print(f"{src} -> {ASSET_DIR / name}")
    elif args.cmd == "bank":
        convert_bank(args.src, args.dst)
    else:
        convert_params(args.src, args.dst)
    return 0


if __name__ == "__main__":
    sys.exit(main())
