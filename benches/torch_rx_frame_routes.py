#!/usr/bin/env python3
"""The RX frame kernel's global instance on its two routes for Bluestein
over two tiles (m = 32,768): device ms a launch of the levels and of the sub
route (``rx_frame.GLOBAL_SUB_FRAMES`` set to take one or the other) at
4-255 frames, in turns, by ``torch.profiler``, at dec 2 / fft_len 8,198 and
dec 1 / fft_len 15,000 (the sub route's scratch of 2 n points a frame at
either end of the fft_len that take m = 32,768); where they cross places
``GLOBAL_SUB_FRAMES``. Every line carries the card's name and power limit.

Run from the repository root on a machine with a CUDA card:
``python3 benches/torch_rx_frame_routes.py``. Imports the port only.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import torch  # noqa: E402

from aether_primitives_tpu_torch.cli import capture, card_label, kernel_device_ms  # noqa: E402
from aether_primitives_tpu_torch.models import RxChainConfig  # noqa: E402
from aether_primitives_tpu_torch.models.modem import _chain_taps  # noqa: E402
from aether_primitives_tpu_torch.ops.cuda import rx_frame as rf  # noqa: E402

card = card_label()
for dec, n in ((2, 8198), (1, 15000)):
    taps = _chain_taps(RxChainConfig(fft_len=n, decimation=dec))
    assert rf.kernel_plan(dec, n, None, len(taps))[0] == "global"
    assert rf.global_layout(dec, n, len(taps))["alt"] is not None
    for frames in (4, 16, 33, 66, 132, 255):
        x = torch.from_numpy(capture(frames * dec * n, 7)).cuda()
        got = {}
        for turn in ("levels", "sub", "sub", "levels"):
            rf.GLOBAL_SUB_FRAMES = 1 if turn == "sub" else 1 << 40
            got.setdefault(turn, []).append(
                kernel_device_ms(lambda: rf.rx_frame(x, taps, dec, n, None, "spectrum"),
                                 "rx_frame"))
        print(f"{dec} / {n}, {frames} frames: levels {min(got['levels']):.4f} ms, sub "
              f"{min(got['sub']):.4f} ms a launch (device, torch.profiler, best of two in "
              f"turns) [{card}]", flush=True)
