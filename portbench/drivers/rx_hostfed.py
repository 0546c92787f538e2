"""RX chain fed from host memory: one channel; ``block``-sample blocks are
successive spans of a ``blocks``-block capture held in pinned host memory
and repeated, the FIR history carried across each wrap. The port's
``StatefulExecutor`` stages each block on its copy stream at ``depth``
blocks in flight; the step it runs is ``RxChain.streaming_step`` followed
by a copy of the packed bits into a pinned host buffer, so a block is done
when its bits are on the host.

A block's latency runs from its hand-off to the executor to its bits on
the host. Sampled blocks (``sample``, drawn from the seed) are held after
the window against the float64 reference of the capture's block with the
history of the block before it.
"""

from __future__ import annotations

import math
import time
from collections import deque

import torch

from ..common import Reservoir, percentile
from ..reference import rx_chain as ref
from ..reference.precision import bf16, identity


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        from aether_primitives_tpu_torch.models import RxChain, RxChainConfig
        from aether_primitives_tpu_torch.parallel import streaming

        t0 = time.perf_counter()
        self.device = device
        self.chain_cfg = config["chain"]
        self.chain = RxChain(RxChainConfig(**self.chain_cfg), device=device)
        n, nb = int(traffic["block"]), int(traffic["blocks"])
        self.n, self.nb, self.depth = n, nb, int(traffic["depth"])
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        cap = torch.randn(nb * n, dtype=torch.complex64, device=device,
                          generator=gen).mul_(math.sqrt(2.0))
        pin = device.type == "cuda"
        self.host = torch.empty(nb * n, dtype=torch.complex64, pin_memory=pin)
        self.host.copy_(cap)
        del cap
        nbytes = n // self.chain_cfg["decimation"] * 2 // 8
        self.ring = [torch.empty(nbytes, dtype=torch.uint8, pin_memory=pin)
                     for _ in range(self.depth + 2)]
        self.sample = Reservoir(int(traffic["sample"]), seed)
        self.kept = torch.empty(self.sample.size, nbytes, dtype=torch.uint8)
        self.exec = streaming.StatefulExecutor(self._chain_step, self.chain.init_state(),
                                               depth=self.depth, printer=None, device=device)
        self.shapes = {"rows": 1, "block": n, "decimation": self.chain_cfg["decimation"],
                       "fft_len": self.chain_cfg["fft_len"], "taps": self.chain.taps.shape[-1]}
        self.sent = 0  # blocks handed to the executor
        self.done = 0  # blocks whose bits are on the host
        self.t_sent = deque()
        self.spans, self.latency = [], []
        self.failed = 0
        t1 = time.perf_counter()
        self._loop(0.0, keep=False, blocks=int(traffic["warmup_blocks"]))
        self.phases = {"system and data": t1 - t0,
                       "warm-up (kernel build or load)": time.perf_counter() - t1}

    def _chain_step(self, x, state):
        t = time.perf_counter()
        bits, state = self.chain.streaming_step(x, state)
        self.spans.append(time.perf_counter() - t)
        out = self.ring[self.sent % len(self.ring)]
        out.copy_(bits, non_blocking=True)
        return out, state

    def _recv(self, keep: bool):
        bits = self.exec.recv()
        self.latency.append(time.perf_counter() - self.t_sent.popleft())
        if keep:
            slot = self.sample.offer(self.done)
            if slot is not None:
                self.kept[slot].copy_(bits)
        self.done += 1

    def _loop(self, seconds: float, keep: bool, blocks: int = 0) -> int:
        t0 = time.perf_counter()
        first = self.done
        while True:
            i = self.sent % self.nb
            self.t_sent.append(time.perf_counter())
            self.exec.send(self.host[i * self.n:(i + 1) * self.n])
            self.sent += 1
            while self.sent - self.done >= self.depth:
                self._recv(keep)
            if (self.sent >= blocks if blocks else time.perf_counter() - t0 >= seconds):
                break
        while self.done < self.sent:
            self._recv(keep)
        return self.done - first

    def window(self, seconds: float) -> dict:
        self.spans, self.latency = [], []
        t0 = time.perf_counter()
        blocks = self._loop(seconds, keep=True)
        elapsed = time.perf_counter() - t0
        return {"metrics": {"rx_msps": blocks * self.n / elapsed / 1e6,
                            "rx_block_p95_ms": percentile(self.latency, 95) * 1e3},
                "attempted": blocks, "spans": {"rx.step": self.spans}}

    def traced(self, seconds: float) -> dict:
        self.spans = []  # the window's spans stay as the window left them
        return {"blocks": self._loop(seconds, keep=False)}

    def release(self):
        self.final_state = self.exec.state.cpu()
        self.exec = self.chain = None
        torch.cuda.empty_cache() if self.device.type == "cuda" else None

    def _block(self, i: int) -> torch.Tensor:
        return self.host[i * self.n:(i + 1) * self.n].to(self.device)[None]

    def _reference(self, i: int, q=identity):
        k = self.shapes["taps"]
        prev = self._block((i - 1) % self.nb)[:, self.n - (k - 1):]
        taps = ref.chain_taps(self.chain_cfg)
        return ref.spectra(self._block(i), prev, taps, self.chain_cfg["decimation"],
                           self.chain_cfg["fft_len"], q)

    def check(self, limits: dict) -> dict:
        """As ``rx_resident``'s: the largest reference margin of a flipped
        bit, the share of bits flipped, the carried history against the last
        block's tail (exact); ``failed`` counts sampled blocks with a flip
        past the margin's limit."""
        worst, flips, bits, failed = 0.0, 0, 0, 0
        for i in range(self.nb):
            slots = [s for s, b in self.sample.taken.items() if b % self.nb == i]
            if not slots:
                continue
            spec = self._reference(i)
            packed, margin = ref.pack(ref.qpsk_bits(spec)), ref.margins(spec)
            for s in slots:
                f, b, w, row_worst = ref.compare(self.kept[s][None], packed, margin)
                flips, bits, worst = flips + f, bits + b, max(worst, w)
                failed += int((row_worst > limits["flip_margin"]).sum())
        k = self.shapes["taps"]
        last = (self.sent - 1) % self.nb
        tail = self.host[(last + 1) * self.n - (k - 1):(last + 1) * self.n]
        self.failed = failed
        return {"flip_margin": worst, "flip_share": flips / max(bits, 1),
                "state_mismatch": int((self.final_state.reshape(-1) != tail).sum())}

    def control(self) -> dict:
        """The numbers with the reference computed in bfloat16 in the
        program's place, over the capture's blocks."""
        worst, flips, bits = 0.0, 0, 0
        for i in range(self.nb):
            spec = self._reference(i)
            packed, margin = ref.pack(ref.qpsk_bits(spec)), ref.margins(spec)
            got = ref.pack(ref.qpsk_bits(self._reference(i, bf16)))
            f, b, w, _ = ref.compare(got, packed, margin)
            flips, bits, worst = flips + f, bits + b, max(worst, w)
        return {"flip_margin": worst, "flip_share": flips / max(bits, 1), "state_mismatch": 0}
