"""Count the instructions of a kernel's innermost loops in a SASS dump.

``cuobjdump -sass <library>.so > sass.txt`` (the CUDA toolkit's
disassembler, on the machine that built the kernels), then ``python -m
xsarsea_tpu_torch.scripts.sass_loops sass.txt group_argmin_kernel``: for
each function whose name holds the given text, every innermost loop (a
backward branch with no other backward branch inside its span), largest
first, with its instruction count and the count per opcode. Dividing a
sweep loop's count by the entries and pixels one iteration covers gives the
instructions per entry and pixel that PERF.md quotes; it needs neither a
GPU nor the toolkit.
"""

from __future__ import annotations

import argparse
import collections
import re

_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?);\s*/\*")
_BRANCH = re.compile(r"\bBRA\b.*?(0x[0-9a-f]+)")


def functions(text):
    """``{name: [(address, instruction text), ...]}`` of a cuobjdump dump."""
    out, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            out[name] = []
        elif name is not None:
            m = _INSTR.match(line)
            if m:
                out[name].append((int(m.group(1), 16), m.group(2).strip()))
    return out


def innermost_loops(instrs):
    """``[(first address, last address, Counter of opcodes)]``, largest first."""
    spans = []
    for addr, ins in instrs:
        m = _BRANCH.search(ins)
        if m and int(m.group(1), 16) <= addr:
            spans.append((int(m.group(1), 16), addr))
    loops = []
    for lo, hi in spans:
        if any((a, b) != (lo, hi) and lo <= a and b <= hi for a, b in spans):
            continue  # holds another loop
        body = [ins for addr, ins in instrs if lo <= addr <= hi]
        ops = collections.Counter(re.sub(r"^@!?U?P\d+\s+", "", ins).split()[0] for ins in body)
        loops.append((lo, hi, ops))
    return sorted(loops, key=lambda loop: -sum(loop[2].values()))


def main(path, pattern, top=4):
    with open(path) as f:
        funcs = functions(f.read())
    for name, instrs in funcs.items():
        if pattern not in name:
            continue
        print(f"{name}: {len(instrs)} instructions")
        for lo, hi, ops in innermost_loops(instrs)[:top]:
            listed = ", ".join(f"{op} {n}" for op, n in ops.most_common())
            print(f"  loop {lo:#06x}-{hi:#06x}: {sum(ops.values())} instructions: {listed}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("sass", help="output of cuobjdump -sass")
    parser.add_argument("kernel", help="text the function's name must hold")
    parser.add_argument("--top", type=int, default=4, help="loops to print per function")
    args = parser.parse_args()
    main(args.sass, args.kernel, args.top)
