#!/usr/bin/env python3
"""Compare the machine code (SASS) of the port's kernel libraries built from
two checkouts, function by function: a change meant to leave some kernels
as they were shows them identical.

    python3 tools/sass_diff.py OLD/src NEW/src [--libs split_stack_gemm,...]

Needs the CUDA toolkit (``nvcc``, ``cuobjdump`` under /usr/local/cuda);
each checkout's libraries are built into its own ``build/kernels``. A
``hopper_kernel`` instance named with the weight-type template argument
at its default (``..., 0>``) is compared with the same instance named
without it. Prints, per library, the functions identical, different, and
present on one side only.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

LIBS = ("split_stack_gemm", "split_grouped_swiglu", "split_grouped_swiglu_demand",
        "split_reduce_gemm", "split_dense_swiglu", "split_grouped_gemm", "flash_attention")
CUOBJDUMP = "/usr/local/cuda/bin/cuobjdump"


def lib_paths(src: str, libs) -> dict:
    """Build ``libs`` from the checkout at ``src`` and return their paths."""
    code = ("import json; from repro_torch.kernels import build; "
            f"build.build_all({tuple(libs)!r}); "
            f"print(json.dumps({{n: str(build._lib_path(n)) for n in {tuple(libs)!r}}}))")
    out = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=src),
                         capture_output=True, text=True, check=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def functions(lib: str) -> dict:
    """{function name: its SASS lines} of a shared library."""
    txt = subprocess.run([CUOBJDUMP, "-sass", lib], capture_output=True, text=True,
                         check=True).stdout
    funcs, name = {}, None
    for line in txt.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            name = re.sub(r"ELi0EEEv", "EEEv", m.group(1))  # the default weight type
            funcs[name] = []
        elif name is not None and "/*" in line:
            funcs[name].append(line.strip())
    return funcs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--libs", default=",".join(LIBS))
    args = ap.parse_args()
    libs = args.libs.split(",")
    old, new = lib_paths(args.old, libs), lib_paths(args.new, libs)
    for lib in libs:
        fo, fn = functions(old[lib]), functions(new[lib])
        same = [k for k in fo if fn.get(k) == fo[k]]
        diff = [k for k in fo if k in fn and fn[k] != fo[k]]
        print(f"sass {lib}: identical {len(same)}, different {len(diff)} {diff}, "
              f"only old {sorted(set(fo) - set(fn))}, only new {sorted(set(fn) - set(fo))}")


if __name__ == "__main__":
    main()
