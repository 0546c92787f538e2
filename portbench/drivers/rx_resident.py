"""RX chain, resident dispatch-ahead: ``channels`` x ``block`` samples a
step from a pool of ``pool`` distinct steps made on the device, dispatched
back to back through ``RxChain.streaming_step`` with the FIR history
carried, a synchronise every ``sync_every`` steps.

The window's outputs are sampled (``sample`` steps, drawn from the seed)
into a device buffer and held, after the window, against the float64
reference of the same step: the pool entry with the history of the one
before it.
"""

from __future__ import annotations

import math
import time

import torch

from ..common import Reservoir
from ..reference import rx_chain as ref
from ..reference.precision import bf16, identity


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        from aether_primitives_tpu_torch.models import RxChain, RxChainConfig

        t0 = time.perf_counter()
        self.device = device
        self.chain_cfg = config["chain"]
        self.chain = RxChain(RxChainConfig(**self.chain_cfg), device=device)
        rows, n, pool = int(traffic["channels"]), int(traffic["block"]), int(traffic["pool"])
        self.rows, self.n, self.npool = rows, n, pool
        self.sync_every = int(traffic["sync_every"])
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        # unit variance a component, as the port's gate draws its capture
        self.pool = torch.randn(pool, rows, n, dtype=torch.complex64, device=device,
                                generator=gen).mul_(math.sqrt(2.0))
        self.state = self.chain.init_state((rows,))
        self.step_no = 0
        self.spans = []
        self.sample = Reservoir(int(traffic["sample"]), seed)
        nbytes = n // self.chain_cfg["decimation"] * 2 // 8
        self.kept = torch.empty(self.sample.size, rows, nbytes, dtype=torch.uint8, device=device)
        self.shapes = {"rows": rows, "block": n, "decimation": self.chain_cfg["decimation"],
                       "fft_len": self.chain_cfg["fft_len"], "taps": self.chain.taps.shape[-1]}
        self.failed = 0
        self._sync()
        t1 = time.perf_counter()
        for _ in range(int(traffic["warmup_steps"])):
            self._step()
        self._sync()
        self.phases = {"system and data": t1 - t0,
                       "warm-up (kernel build or load)": time.perf_counter() - t1}

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _step(self):
        x = self.pool[self.step_no % self.npool]
        t = time.perf_counter()
        bits, self.state = self.chain.streaming_step(x, self.state)
        self.spans.append(time.perf_counter() - t)
        self.step_no += 1
        return bits

    def _loop(self, seconds: float, keep: bool) -> int:
        self._sync()
        t0 = time.perf_counter()
        steps = 0
        while True:
            bits = self._step()
            if keep:
                slot = self.sample.offer(self.step_no - 1)
                if slot is not None:
                    self.kept[slot].copy_(bits)
            steps += 1
            if steps % self.sync_every == 0:
                self._sync()
                if time.perf_counter() - t0 >= seconds:
                    return steps

    def window(self, seconds: float) -> dict:
        self.spans = []
        t0 = time.perf_counter()
        steps = self._loop(seconds, keep=True)
        self._sync()
        elapsed = time.perf_counter() - t0
        return {"metrics": {"rx_msps": steps * self.rows * self.n / elapsed / 1e6,
                            "rx_step_ms": elapsed / steps * 1e3},
                "attempted": steps * self.rows, "spans": {"rx.step": self.spans}}

    def traced(self, seconds: float) -> dict:
        self.spans = []  # the window's spans stay as the window left them
        return {"steps": self._loop(seconds, keep=False)}

    def release(self):
        """Frees what only the program holds; the pool stays, the reference
        reads it."""
        self.final_state = self.state
        self.chain = None
        torch.cuda.empty_cache() if self.device.type == "cuda" else None

    def _history(self, p: int) -> torch.Tensor:
        k = self.shapes["taps"]
        return self.pool[(p - 1) % self.npool][:, self.n - (k - 1):]

    def _reference(self, p: int, q=identity):
        taps = ref.chain_taps(self.chain_cfg)
        dec, fft_len = self.chain_cfg["decimation"], self.chain_cfg["fft_len"]
        return ref.spectra(self.pool[p], self._history(p), taps, dec, fft_len, q)

    def check(self, limits: dict) -> dict:
        """The numbers compared: the largest reference margin of a flipped
        bit, the share of bits flipped, and the carried history's samples
        that differ from the last step's tail (exact). ``failed`` counts the
        sampled channel-blocks with a flipped bit past the margin's limit."""
        worst, flips, bits, failed = 0.0, 0, 0, 0
        for p in range(self.npool):
            slots = [s for s, step in self.sample.taken.items() if step % self.npool == p]
            if not slots:
                continue
            spec = self._reference(p)
            packed, margin = ref.pack(ref.qpsk_bits(spec)), ref.margins(spec)
            del spec
            for s in slots:
                f, b, w, row_worst = ref.compare(self.kept[s], packed, margin)
                flips, bits, worst = flips + f, bits + b, max(worst, w)
                failed += int((row_worst > limits["flip_margin"]).sum())
            del packed, margin
        last = (self.step_no - 1) % self.npool
        tail = self._history(last + 1)
        state_bad = int((self.final_state != tail).sum())
        self.failed = failed
        return {"flip_margin": worst, "flip_share": flips / max(bits, 1),
                "state_mismatch": state_bad}

    def control(self) -> dict:
        """The same numbers with the reference computed in bfloat16 in the
        program's place, over the pool's steps."""
        worst, flips, bits = 0.0, 0, 0
        for p in range(self.npool):
            spec = self._reference(p)
            packed, margin = ref.pack(ref.qpsk_bits(spec)), ref.margins(spec)
            got = ref.pack(ref.qpsk_bits(self._reference(p, bf16)))
            f, b, w, _ = ref.compare(got, packed, margin)
            flips, bits, worst = flips + f, bits + b, max(worst, w)
        return {"flip_margin": worst, "flip_share": flips / max(bits, 1), "state_mismatch": 0}
