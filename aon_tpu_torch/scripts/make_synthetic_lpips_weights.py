"""Write a SYNTHETIC (random-weight) LPIPS VGG16 .npz for plumbing tests
(port of ``scripts/make_synthetic_lpips_weights.py``, without JAX).

The pretrained VGG16 weights are converted offline from torchvision's and
the LPIPS heads (``weights/README.md``).  This script writes an .npz with the
converter's keys and shapes, random He-scaled conv filters, zero biases and
non-negative 1x1 heads, plus a ``__synthetic__`` marker, so that an
evaluation run with it labels its LPIPS ``"lpips_weights": "synthetic"`` in
results.json (``eval/lpips.py`` reads the marker).  Its values mean nothing
as a perceptual metric; they exercise the whole LPIPS path.  From the same
seed it writes the same arrays as the JAX package's script.

    python -m aon_tpu_torch.scripts.make_synthetic_lpips_weights --out weights/lpips_vgg.npz
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from aon_tpu_torch.eval.lpips import _TAPS, _VGG_CFG, SYNTHETIC_MARKER


def synthetic_weights(seed: int = 0) -> dict:
    """The arrays of the synthetic npz, marker included."""
    g = np.random.default_rng(seed)
    params = {SYNTHETIC_MARKER: np.array(True)}
    cin, conv_idx, tap_channels = 3, 0, []
    for item in _VGG_CFG:
        if item == "M":
            continue
        # He-scaled filters keep the activations in range through 13 convs
        std = np.sqrt(2.0 / (9 * cin))
        params[f"conv{conv_idx}_w"] = g.normal(0, std, (3, 3, cin, item)).astype(np.float32)
        params[f"conv{conv_idx}_b"] = np.zeros(item, np.float32)
        if conv_idx in _TAPS:
            tap_channels.append(item)
        cin = item
        conv_idx += 1
    for i, c in enumerate(tap_channels):
        params[f"lin{i}_w"] = np.abs(g.normal(0, 1.0 / c, (1, 1, c, 1))).astype(np.float32)
    return params


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="weights/lpips_vgg.synthetic.npz")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    params = synthetic_weights(args.seed)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez(args.out, **params)
    n_convs = sum(1 for k in params if k.startswith("conv") and k.endswith("_w"))
    n_lins = sum(1 for k in params if k.startswith("lin"))
    print(f"wrote SYNTHETIC lpips weights to {args.out} ({n_convs} convs, {n_lins} lin heads)")
    return args.out


if __name__ == "__main__":
    main()
