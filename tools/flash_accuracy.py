#!/usr/bin/env python3
"""The float32 flash_attention kernel's error on long one-signed sums.

    python3 tools/flash_accuracy.py [--src DIR] [--label NAME]
        [--model] [--save DIR | --load DIR]

Imports ``repro_torch`` from DIR (default: this checkout's ``src``),
builds its CUDA kernels and prints one JSON line per case: the float32
kernel's max |difference| from the plain version, and the kernel's and
the plain version's max |difference| from float64 attention
(``chip_smoke.flash_f64``), beside max|out|.  The cases: q and k unit
normal and v = 1 + N(0, 1), whose outputs are one-signed sums of about 1
over every key, at whisper-large-v3's encoder shape (B4 S1500 Sk1500 H20
D64) and at Sk 8192.  With ``--model``, also every layer of
whisper-large-v3's encoder in float32 (seed-0 weights and frames as
``chip_smoke.py`` phase 13 draws them; it needs a checkout that has the
encoder); ``--save DIR`` keeps the q, k and v of layers 24 and 31 there,
and ``--load DIR`` runs only those saved inputs, so an older checkout's
kernel can be held to the same layers.  Run it once per checkout, each
in its own process, to compare two versions on one card (parent,
change, change, parent).  Needs a CUDA card; it imports no JAX.
"""
import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SAVED_LAYERS = (24, 31)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--model", action="store_true")
    ap.add_argument("--save", type=Path)
    ap.add_argument("--load", type=Path)
    args = ap.parse_args()
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    sys.path.insert(0, str(args.src))
    sys.path.insert(1, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        sys.exit("flash_accuracy: no CUDA device")
    import chip_smoke as C
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    _build.build_all()

    def report(case, q, k, v, causal=False):
        got = flash_attention(q, k, v, causal=causal)
        plain = flash_attention_plain(q, k, v, causal=causal)
        f64 = C.flash_f64(q, k, v, causal)
        print(json.dumps(dict(
            label=args.label, case=case, shape=[list(q.shape),
                                                list(k.shape)],
            kernel_vs_plain=float((got - plain).abs().max()),
            kernel_vs_f64=float((got.double() - f64).abs().max()),
            plain_vs_f64=float((plain.double() - f64).abs().max()),
            max_out=float(plain.abs().max()))), flush=True)
        return got

    if args.load:
        for n in SAVED_LAYERS:
            q, k, v = (t.cuda() for t in torch.load(
                args.load / f"encoder_layer_{n}.pt"))
            report(f"whisper encoder layer {n}", q, k, v)
    g = torch.Generator(device="cuda").manual_seed(5)
    for B, Sk, S, H in ((4, 1500, 1500, 20), (2, 8192, 256, 4)):
        q = torch.randn((B, S, H, 64), generator=g, device="cuda")
        k = torch.randn((B, Sk, H, 64), generator=g, device="cuda")
        v = torch.randn((B, Sk, H, 64), generator=g, device="cuda") + 1.0
        report("v = 1 + N(0, 1)", q, k, v)
    if not args.model:
        return
    import repro_torch.models.attention as att
    from repro_torch.models import transformer as T
    cfg, params, _, _ = C.lm_weights(C.WHISPER_ARCH, "float32", False)
    batch = C.encdec_batch(cfg, C.WHISPER_B)
    layer = []

    def probe(q, k, v, *, causal=True):
        if args.save and len(layer) in SAVED_LAYERS:
            args.save.mkdir(parents=True, exist_ok=True)
            torch.save((q.cpu(), k.cpu(), v.cpu()),
                       args.save / f"encoder_layer_{len(layer)}.pt")
        layer.append(None)
        return report(f"whisper encoder layer {len(layer) - 1}", q, k, v,
                      causal)
    att.flash_attention = probe
    with torch.inference_mode():
        T._encode(params.tree(), cfg, batch["frames"])


if __name__ == "__main__":
    main()
