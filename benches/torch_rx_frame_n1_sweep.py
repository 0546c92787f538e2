#!/usr/bin/env python3
"""Stage-split sweep of the PyTorch port's RX frame kernel on one CUDA card.

Times ``rx_frame`` (QPSK bytes, zero history) and its plain PyTorch version
on one 4,194,304-sample block of the main path's geometry (fft_len 2048,
decimation 4, the 65-tap default lowpass) at each stage split ``stage_n1``
the kernel takes, and prints per split the FP32 work, the G' and Cm bytes
the kernel re-reads from L2, and the spectrum's RMS EVM against the float64
chain. Tests whether the kernel follows its FP32 work or its L2 traffic.

Run from the repository root on a machine with a CUDA card:
``python3 benches/torch_rx_frame_n1_sweep.py``. Imports the port only.
"""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from aether_primitives_tpu_torch.cli import (  # noqa: E402
    BLOCK, capture, card_label, numpy_reference_spectra, time_cuda,
)
from aether_primitives_tpu_torch.evm import evm_rms_db  # noqa: E402
from aether_primitives_tpu_torch.models import RxChain, RxChainConfig  # noqa: E402
from aether_primitives_tpu_torch.ops.cuda import rx_frame as rf  # noqa: E402

DEC, FFT_LEN = 4, 2048
SPLITS = (64, 128, 256)
ITERS, RUNS = 40, 3


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_label()
    print(card)
    taps = RxChain(RxChainConfig(fft_len=FFT_LEN, decimation=DEC)).taps
    ku = taps.shape[-1] - 1
    x = capture(BLOCK)
    ref = numpy_reference_spectra(x, taps, DEC, FFT_LEN)
    xd = torch.from_numpy(x).cuda()
    frames = BLOCK // (DEC * FFT_LEN)
    for n1 in SPLITS:
        n2, r = DEC * FFT_LEN // n1, FFT_LEN // n1
        plan = rf.staged_plan(DEC, FFT_LEN, n1, ku + 1)
        if plan is None:
            print(f"n1={n1}: no staged instance takes this split")
            continue
        spec = rf.launch_staged(xd, None, taps, DEC, FFT_LEN, "spectrum", plan)
        evm = evm_rms_db(spec.cpu().numpy(), ref)
        runs = [time_cuda(lambda: rf.launch_staged(xd, None, taps, DEC, FFT_LEN, "qpsk", plan),
                          ITERS) for _ in range(RUNS)]
        plain = time_cuda(
            lambda: rf.rx_frame_reference(xd, taps, DEC, FFT_LEN, None, "qpsk", n1),
            ITERS)
        ms = float(np.median(runs))
        stage1 = frames * n1 * n1 * n2  # complex MACs
        stage2 = frames * (n1 * n2 * r + ku * FFT_LEN)
        l2 = frames * FFT_LEN * (n2 + ku) * 8  # G' and Cm float32 planes per frame
        tflops = (stage1 + stage2) * 8 / (ms * 1e-3) / 1e12
        print(f"n1={n1} n2={n2} r={r}: {plan[0]} kernel {ms:.4f} ms (runs "
              f"{[round(v, 4) for v in runs]}), plain {plain:.4f} ms, evm {evm:.2f} dB, "
              f"stage1 {stage1 / 1e9:.3f} G cMAC, stage2+corr {stage2 / 1e9:.3f} G cMAC, "
              f"G'+Cm L2 reads {l2 / 1e9:.3f} GB, {tflops:.1f} TFLOP/s [{card}]")


if __name__ == "__main__":
    main()
