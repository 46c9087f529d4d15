#!/usr/bin/env python3
"""Registers, spills and static shared memory of the port's CUDA kernels.

Builds every ``split_learning_tpu_torch/csrc/*.cu`` with the port's own
``nvcc`` flags plus ``-Xptxas -v`` (one ``nvcc`` per source, all started
together, into a temporary directory) and prints one line per kernel:
source, demangled name, registers a thread, spill bytes, and the shared
memory ptxas can see (dynamic shared memory, which the flash kernels
use, is set at launch and given in their source headers). Needs the CUDA
toolkit; a machine without ``nvcc`` gets the build's error.

    python3 scripts/port_kernel_resources.py [name-filter]
"""

import os
import re
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from split_learning_tpu_torch.ops import common  # noqa: E402


def main() -> int:
    only = sys.argv[1] if len(sys.argv) > 1 else ""
    nvcc = common._nvcc()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [(src, subprocess.Popen(
            [nvcc, *common.NVCC_FLAGS, "-Xptxas", "-v", "-I",
             str(common.CSRC_DIR), "-o", os.path.join(tmp, src.stem + ".so"),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)) for src in sorted(common.CSRC_DIR.glob("*.cu"))]
        for src, proc in procs:
            out = proc.communicate()[0]
            if proc.returncode:
                print(out)
                return proc.returncode
            lines = out.splitlines()
            for i, line in enumerate(lines):
                entry = re.search(r"Compiling entry function '(\S+)'", line)
                if not entry:
                    continue
                name = subprocess.run(
                    ["c++filt", entry.group(1)], capture_output=True,
                    text=True).stdout.strip().replace(
                        "(anonymous namespace)::", "").removeprefix(
                        "void ").split("(")[0]
                info = " ".join(lines[i + 1:i + 4])
                regs = re.search(r"Used (\d+) registers", info)
                spill = re.search(r"(\d+) bytes spill stores", info)
                smem = re.search(r"(\d+) bytes smem", info)
                if only in name:
                    print(f"{src.name}: {name}: "
                          f"{regs.group(1) if regs else '?'} registers, "
                          f"{spill.group(1) if spill else '0'} bytes spilled, "
                          f"{smem.group(1) if smem else '0'} bytes static "
                          "shared memory")
    return 0


if __name__ == "__main__":
    sys.exit(main())
