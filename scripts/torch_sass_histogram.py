"""The machine code of a kernel source, counted by opcode (needs the CUDA
toolkit's nvcc and cuobjdump, not a card):

    python3 scripts/torch_sass_histogram.py vstnet_tpu_torch/csrc/dwconv.cu

Compiles the source alone with the flags of ops/_build.py to a cubin,
disassembles it with cuobjdump -sass and prints, for every kernel in it,
the instruction count and the most frequent opcodes (modifiers dropped).
A static count: a loop body is counted once, however often it runs.
"""

from __future__ import annotations

import collections
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from vstnet_tpu_torch.ops import _build  # noqa: E402

_OP = re.compile(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def main():
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    src = Path(sys.argv[1]).resolve()
    nvcc = _build._nvcc()
    with tempfile.TemporaryDirectory() as work:
        cubin = str(Path(work) / "k.cubin")
        subprocess.run([nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                        "-cubin", "-o", cubin, str(src)], check=True)
        sass = subprocess.run(
            [str(Path(nvcc).parent / "cuobjdump"), "-sass", cubin],
            capture_output=True, text=True, check=True).stdout
    for body in re.split(r"\n\s*Function : ", sass)[1:]:
        name = body.splitlines()[0].strip()
        ops = collections.Counter(
            m.group(1).split(".")[0] for m in map(_OP.match, body.splitlines())
            if m)
        print(f"{name}: {sum(ops.values())} instructions; "
              + ", ".join(f"{k} {v}" for k, v in ops.most_common(24)))


if __name__ == "__main__":
    main()
