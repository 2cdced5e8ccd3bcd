"""Which kernels two builds of the kernel library compile differently:
their SASS compared function by function.

    python -m vulkan_pathtracer_tpu_torch.app.sass_diff OLD.so NEW.so

Each argument is a ``build/torch_kernels/<hash>/libvkpt_torch_kernels.so``
(``ops/kernels.build()`` of a checkout).  Disassembles both with the
toolkit's ``cuobjdump -sass`` and prints one line per entry function,
``same`` or ``DIFF`` with its instruction counts in OLD and NEW, then
``ALL_IDENTICAL`` or ``DIFFERENT n``.  The per-file hash in the names of
anonymous namespaces is normalised, so two checkouts at different paths
compare.  A function whose SASS is identical runs the same instructions,
so a change that leaves a kernel's SASS alone cannot move its time.
Needs the CUDA toolkit.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess

_ANON = re.compile(r"_GLOBAL__N__[0-9a-f]+_\d+_(\w+?_cu)_[0-9a-f]+")
_FUNC = re.compile(r"\s*Function : (\S+)")


def _cuobjdump() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in (CUDA_HOME and os.path.join(CUDA_HOME, "bin", "cuobjdump"),
                 shutil.which("cuobjdump"), "/usr/local/cuda/bin/cuobjdump"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("cuobjdump not found (set CUDA_HOME)")


def functions(lib: str) -> dict[str, list[str]]:
    """Entry function name -> its SASS lines, of one library."""
    out = subprocess.run([_cuobjdump(), "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    funcs, name = {}, None
    for line in _ANON.sub(r"ANON_\1", out).splitlines():
        m = _FUNC.match(line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None and line.strip():
            funcs[name].append(line.strip())
    return funcs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old")
    ap.add_argument("new")
    args = ap.parse_args(argv)
    a, b = functions(args.old), functions(args.new)
    print(f"functions: {len(a)} / {len(b)}")
    diff = 0
    for name in sorted(set(a) | set(b)):
        same = a.get(name) == b.get(name)
        diff += not same
        print(f"{'same' if same else 'DIFF'} {len(a.get(name, []))} "
              f"{len(b.get(name, []))} {name}")
    print("ALL_IDENTICAL" if diff == 0 else f"DIFFERENT {diff}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
