#!/usr/bin/env python3
"""Whether the RX frame kernel's main-path instance compiles to the same
machine code in two checkouts.

Builds ``aether_primitives_tpu_torch/csrc/rx_frame.cu`` of this tree and of
``--parent DIR`` to cubins for sm_90a with the port's nvcc flags, dumps
each with ``cuobjdump -sass``, takes the QPSK, BPSK and spectrum kernels of
the direct instance at 256 threads with real taps
(``rx_frame_direct_kernel<EPI, 256, 3, true[, false]>``, the main path's
since it was written) and compares their instructions with addresses, encodings and
symbol names dropped. Prints one line per epilogue: instruction counts and
whether the two listings are identical.

Run from the repository root on a machine with the CUDA toolkit:
``python3 benches/torch_rx_frame_sass_diff.py --parent DIR``.
"""

import argparse
import re
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from aether_primitives_tpu_torch.ops.cuda import build  # noqa: E402

EPILOGUES = {0: "qpsk", 1: "bpsk", 2: "spectrum"}


def sass(src: Path, out_dir: Path) -> dict:
    """``{epilogue: [instructions]}`` of the main path's direct kernels in
    ``src``."""
    cubin = out_dir / (src.parent.parent.parent.name + ".cubin")
    flags = [f for f in build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC",
                                                      "-Xptxas", "-v")]
    subprocess.run([build.find_nvcc(), *flags, "-cubin", "-o", str(cubin), str(src)],
                   check=True, capture_output=True, text=True)
    nvcc = Path(build.find_nvcc())
    dump = subprocess.run([str(nvcc.parent / "cuobjdump"), "-sass", str(cubin)], check=True,
                          capture_output=True, text=True).stdout
    funcs, name = {}, None
    for line in dump.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if name and m:
            # drop symbol names (mangled differently per template signature)
            funcs[name].append(re.sub(r"_Z\w+", "SYM", m.group(1)))
    out = {}
    for fname, body in funcs.items():
        # the power-of-two form (a trailing kMixed = false since the mixed-radix one)
        m = re.search(r"rx_frame_direct_kernelILi(\d)ELi256ELi3ELb1E(?:Lb0E)?EEv", fname)
        if m:
            out[EPILOGUES[int(m.group(1))]] = body
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="a checkout to compare this tree with")
    args = ap.parse_args()
    here = build.PACKAGE_DIR / "csrc" / "rx_frame.cu"
    there = Path(args.parent) / "aether_primitives_tpu_torch" / "csrc" / "rx_frame.cu"
    with tempfile.TemporaryDirectory() as tmp:
        a_dir, b_dir = Path(tmp, "a"), Path(tmp, "b")
        a_dir.mkdir()
        b_dir.mkdir()
        a, b = sass(there, a_dir), sass(here, b_dir)
    for epi in EPILOGUES.values():
        same = a.get(epi) == b.get(epi) and a.get(epi) is not None
        print(f"rx_frame {epi}, direct instance: {len(a.get(epi, []))} instructions in "
              f"the parent, {len(b.get(epi, []))} here; identical SASS: {same}")


if __name__ == "__main__":
    main()
