"""Standalone interpolation CLI (ref interpolate.py:96-127 parity).

`msnv-interpolate-torch`, the port's counterpart of the JAX package's
msnv-interpolate: the same flags and files, on the port's
ops/interpolate.py (numpy).

Interpolates Ahocoder lf0 / voiced-frequency files over unvoiced runs and
writes `<name>.i<ext>` (+ `<name>.uv` U/V masks unless --no-uv).

Usage:
  python -m msnv_tpu_torch.cli.interpolate --f0_file x.lf0
  python -m msnv_tpu_torch.cli.interpolate --vf_guia list.txt
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from msnv_tpu_torch.ops.interpolate import interpolation

F0_UNVOICED = -1e10
VF_UNVOICED = 1e3


def process_file(filename: str, unvoiced_symbol: float, gen_uv: bool):
    dire, fullname = os.path.split(filename.rstrip())
    basename, ext = os.path.splitext(fullname)
    raw = np.loadtxt(filename)
    interp, uv = interpolation(raw, unvoiced_symbol)
    out_interp = os.path.join(dire, basename + ".i" + ext)
    print(f"Writing interpolation to {out_interp}")
    np.savetxt(out_interp, interp)
    if gen_uv:
        out_uv = os.path.join(dire, basename + ".uv")
        print(f"Writing u/v mask to {out_uv}")
        np.savetxt(out_uv, uv, fmt="%d")


def process_guia(guia_file: str, unvoiced_symbol: float, gen_uv: bool):
    with open(guia_file) as fh:
        for filename in fh:
            if filename.strip():
                process_file(filename.rstrip(), unvoiced_symbol, gen_uv)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Interpolate Ahocoder features over unvoiced runs")
    p.add_argument("--f0_guia")
    p.add_argument("--f0_file")
    p.add_argument("--vf_guia")
    p.add_argument("--vf_file")
    p.add_argument("--no-uv", dest="gen_uv", action="store_false")
    p.set_defaults(gen_uv=True)
    args = p.parse_args(argv)
    if args.f0_file:
        process_file(args.f0_file, F0_UNVOICED, args.gen_uv)
    if args.f0_guia:
        process_guia(args.f0_guia, F0_UNVOICED, args.gen_uv)
    if args.vf_file:
        process_file(args.vf_file, VF_UNVOICED, args.gen_uv)
    if args.vf_guia:
        process_guia(args.vf_guia, VF_UNVOICED, args.gen_uv)


if __name__ == "__main__":
    main()
