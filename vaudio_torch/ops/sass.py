"""Count the SASS instructions of a kernel's loops.

    python -m vaudio_torch.ops.sass [--kernel NAME] [--marker OPCODE] FILE...

Each FILE is a CUDA source (compiled here with ``nvcc -cubin`` and the
library's flags) or a compiled object, cubin or shared library.  For every
function whose mangled name contains NAME (default ``hann_peak``), the
script reads ``cuobjdump -sass``, finds each loop (a branch back to a lower
address), and prints one JSON line per loop: its static instruction count,
the count of the marker opcode in it (default ``FCHK``, the range check of
the IEEE divide, once per peak evaluation of K2), the instructions per
marker, and the count by opcode.  Code out of the loop's line (the divide's slow path, which
is called) is not counted.  Needs the CUDA toolkit: it runs on the machine
with the card.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import tempfile
from collections import Counter
from pathlib import Path

_FUNC = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSN = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_TARGET = re.compile(r"0x([0-9a-f]+)")
_BRANCHES = ("BRA", "BRX", "JMP")


def parse(text: str) -> dict:
    """``cuobjdump -sass`` output -> {function: [(address, opcode,
    operands)]} (a branch's operands hold its target address in hex)."""
    funcs: dict = {}
    cur = None
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2), m.group(3).strip()))
    return funcs


def loops(insns: list, marker: str = "FCHK") -> list:
    """The loops of one function, shortest first: a dict each with the
    address span, the instruction count, the count of ``marker`` in it (and
    the instructions per marker) and the count by opcode (the opcode's
    first word)."""
    found = []
    for addr, op, args in insns:
        if op.split(".")[0] not in _BRANCHES:
            continue
        m = _TARGET.search(args)
        if not m:
            continue
        start = int(m.group(1), 16)
        if start > addr:
            continue
        body = [o for a, o, _ in insns if start <= a <= addr]
        ops = Counter(o.split(".")[0] for o in body)
        found.append({"start": f"0x{start:x}", "end": f"0x{addr:x}",
                      "instructions": len(body), "markers": ops[marker],
                      "per_marker": (len(body) / ops[marker]
                                     if ops[marker] else None),
                      "by_opcode": dict(ops.most_common())})
    return sorted(found, key=lambda d: d["instructions"])


def _tool(name: str) -> str:
    from vaudio_torch.ops import _build
    found = shutil.which(name) or str(Path(_build._nvcc()).parent / name)
    if not Path(found).exists():
        raise RuntimeError(f"{name} not found")
    return found


def sass_of(path: Path, work: Path) -> str:
    """The SASS text of a source (compiled with the library's flags) or of
    a compiled file."""
    if path.suffix in (".cu", ".cuh"):
        from vaudio_torch.ops import _build
        cubin = work / (path.stem + ".cubin")
        flags = [f for f in _build.NVCC_FLAGS
                 if f not in ("-Xcompiler", "-fPIC", "-Xptxas", "-v")]
        subprocess.run([_tool("nvcc"), *flags, "-cubin", "-o", str(cubin),
                        str(path)], check=True)
        path = cubin
    return subprocess.run([_tool("cuobjdump"), "-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("files", nargs="+", type=Path)
    ap.add_argument("--kernel", default="hann_peak")
    ap.add_argument("--marker", default="FCHK")
    args = ap.parse_args(argv)
    from vaudio_torch.ops import _build
    _build.BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_ROOT) as tmp:
        for path in args.files:
            for func, insns in parse(sass_of(path, Path(tmp))).items():
                if args.kernel not in func:
                    continue
                for loop in loops(insns, args.marker):
                    print(json.dumps({"file": str(path), "function": func,
                                      "function_instructions": len(insns),
                                      **loop}), flush=True)


if __name__ == "__main__":
    main()
