"""tpuutil-torch — utility-plugin runner (the mtsutil analog) of the port.

Counterpart of gradientdomain_mitsuba_tpu/utils/mtsutil.py (`tpuutil`,
src/mitsuba/mtsutil.cpp + src/utils/): instead of dlopen'ing utility
plugins by name, each utility is an argparse subcommand over the port's
own image I/O (utils/exr.py).  Pure numpy; PNG/JPEG go through PIL.

  tpuutil-torch addimages [-m a] [-M b] in1 in2 out   a*in1 + b*in2
                                                (src/utils/addimages.cpp)
  tpuutil-torch joinrgb r.exr g.exr b.exr out.exr     merge per-channel EXRs
                                                (src/utils/joinrgb.cpp)
  tpuutil-torch tonemap [-g gamma] [-m mult] in out   EXR -> LDR png/jpg
  tpuutil-torch diff a.exr b.exr [--fail-above X]     print relMSE/MSE (the
                                                quality-metric helper)
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def _read(path):
    if path.lower().endswith(".exr"):
        from . import exr
        return exr.read_rgb(path)
    if path.lower().endswith(".npy"):
        return np.load(path).astype(np.float32)
    from PIL import Image
    return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0


def _write(path, img):
    img = np.asarray(img, np.float32)
    if path.lower().endswith(".exr"):
        from . import exr
        exr.write(path, img)
    elif path.lower().endswith(".npy"):
        np.save(path, img)
    else:
        from PIL import Image
        srgb = np.where(img <= 0.0031308, img * 12.92,
                        1.055 * np.clip(img, 0, None) ** (1 / 2.4) - 0.055)
        Image.fromarray(
            (np.clip(srgb, 0, 1) * 255 + 0.5).astype(np.uint8)).save(path)


def cmd_addimages(args):
    a = _read(args.in1)
    b = _read(args.in2)
    if a.shape != b.shape:
        raise SystemExit(f"shape mismatch: {a.shape} vs {b.shape}")
    _write(args.out, args.m * a + args.M * b)
    print(f"[tpuutil] {args.m} * {args.in1} + {args.M} * {args.in2} "
          f"-> {args.out}")


def cmd_joinrgb(args):
    def chan(path, idx):
        img = _read(path)
        return img[..., min(idx, img.shape[-1] - 1)]
    _write(args.out, np.stack([chan(args.r, 0), chan(args.g, 1),
                               chan(args.b, 2)], axis=-1))
    print(f"[tpuutil] joined {args.r}/{args.g}/{args.b} -> {args.out}")


def cmd_tonemap(args):
    img = _read(args.input) * args.m
    if args.out.lower().endswith((".png", ".jpg", ".jpeg")) and \
            args.g != 2.2:  # explicit gamma overrides the sRGB curve
        from PIL import Image
        ldr = np.clip(img, 0, None) ** (1.0 / args.g)
        Image.fromarray(
            (np.clip(ldr, 0, 1) * 255 + 0.5).astype(np.uint8)
        ).save(args.out)
    else:
        _write(args.out, img)
    print(f"[tpuutil] tonemapped {args.input} -> {args.out}")


def cmd_diff(args):
    a = _read(args.a)
    ref = _read(args.b)
    mse = float(np.mean((a - ref) ** 2))
    rel = float(np.mean((a - ref) ** 2 /
                        (np.mean(ref, -1, keepdims=True) ** 2 + 1e-2)))
    print(f"MSE {mse:.6g}  relMSE {rel:.6g}")
    return 1 if (args.fail_above is not None and
                 rel > args.fail_above) else 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="tpuutil-torch", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    pa = sub.add_parser("addimages", help="weighted sum of two images")
    pa.add_argument("-m", type=float, default=1.0,
                    help="weight of the first image")
    pa.add_argument("-M", type=float, default=1.0,
                    help="weight of the second image")
    pa.add_argument("in1")
    pa.add_argument("in2")
    pa.add_argument("out")
    pa.set_defaults(fn=cmd_addimages)

    pj = sub.add_parser("joinrgb", help="merge three EXRs into RGB")
    pj.add_argument("r")
    pj.add_argument("g")
    pj.add_argument("b")
    pj.add_argument("out")
    pj.set_defaults(fn=cmd_joinrgb)

    pt = sub.add_parser("tonemap", help="HDR -> LDR conversion")
    pt.add_argument("-g", type=float, default=2.2, help="gamma")
    pt.add_argument("-m", type=float, default=1.0, help="multiplier")
    pt.add_argument("input")
    pt.add_argument("out")
    pt.set_defaults(fn=cmd_tonemap)

    pd = sub.add_parser("diff", help="print MSE/relMSE between images")
    pd.add_argument("a")
    pd.add_argument("b")
    pd.add_argument("--fail-above", type=float, default=None,
                    help="exit 1 when relMSE exceeds this")
    pd.set_defaults(fn=cmd_diff)

    args = p.parse_args(argv)
    return args.fn(args) or 0


if __name__ == "__main__":
    sys.exit(main())
