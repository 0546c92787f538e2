"""Burst link, closed loop with one caller: each call is
``PacketModem.rx_batch`` on ``bursts`` captures of ``window`` samples from a
pool of ``pool`` distinct batches resident on the device; a call ends when
its payloads and CRC flags are on the host.

Each capture holds one burst of the frozen transmitter
(``gen/burst_tx.py``) through the channel (``gen/channel.py``): a uniform
offset, a uniform carrier offset within ``max_cfo``, a unit gain of uniform
phase, AWGN at ``ebn0_db`` per information bit. Sampled calls (``sample``,
drawn from the seed) are held after the window against what was sent and
against the float64 reference receiver on the same captures.
"""

from __future__ import annotations

import time

import torch

from ..common import Reservoir, percentile
from ..gen import channel
from ..gen.burst_tx import Link
from ..reference import burst_rx
from ..reference.precision import bf16, identity


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        from aether_primitives_tpu_torch.models import PacketConfig, PacketModem

        t0 = time.perf_counter()
        self.device = device
        packet = config["packet"]
        self.modem = PacketModem(PacketConfig(**packet), device=device)
        self.link = link = Link(packet)
        b, w, pool = int(traffic["bursts"]), int(traffic["window"]), int(traffic["pool"])
        self.b, self.npool = b, pool
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        sigma = channel.noise_sigma(float(traffic["ebn0_db"]), link.payload_bits,
                                    link.coded_bits, 2, 2.0)
        self.payloads, self.caps = [], []
        for _ in range(pool):
            pay = torch.randint(0, 2, (b, link.payload_bits), dtype=torch.uint8,
                                device=device, generator=gen)
            caps, _truth = channel.captures(link.tx(pay), w, sigma,
                                            float(traffic["max_cfo"]), gen)
            self.payloads.append(pay)
            self.caps.append(caps)
        self.calls = 0
        self.sample = Reservoir(int(traffic["sample"]), seed)
        self.shapes = {"bursts": b, "window": w, "coded_steps": link.coded_bits // 2,
                       "constraint": link.k, "polys": (0o171, 0o133)}
        self.failed = 0
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        for _ in range(int(traffic["warmup_calls"])):
            self._call()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.phases = {"system and data": t1 - t0,
                       "warm-up (kernel build or load)": time.perf_counter() - t1}

    def _call(self):
        p = self.calls % self.npool
        t = time.perf_counter()
        pay, ok, diag = self.modem.rx_batch(self.caps[p])
        pay, ok = pay.cpu(), ok.cpu()
        lat = time.perf_counter() - t
        self.calls += 1
        return pay, ok, diag, lat

    def window(self, seconds: float) -> dict:
        lat, passed, calls = [], 0, 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            pay, ok, diag, dt = self._call()
            lat.append(dt)
            passed += int(ok.sum())
            slot = self.sample.offer(self.calls - 1)
            if slot is not None:
                self.sample.taken[slot] = (self.calls - 1, pay, ok, diag["gain"], diag["cfo"])
            calls += 1
        elapsed = time.perf_counter() - t0
        self.failed = calls * self.b - passed
        return {"metrics": {"bursts_per_s": passed / elapsed,
                            "burst_call_p95_ms": percentile(lat, 95) * 1e3},
                "attempted": calls * self.b, "spans": {}}

    def traced(self, seconds: float) -> dict:
        t0, calls = time.perf_counter(), 0
        while time.perf_counter() - t0 < seconds:
            self._call()
            calls += 1
        return {"calls": calls}

    def release(self):
        self.modem = None
        torch.cuda.empty_cache() if self.device.type == "cuda" else None

    def _numbers(self, results, reference) -> dict:
        """``results``: ``(pool index, payload, crc_ok, gain, cfo)`` a
        batch; ``reference``: the reference's ``(payload, crc_ok,
        estimates)`` a pool batch."""
        wrong = lost = sure = 0
        room = (self.link.rs_n - self.link.rs_k) // 4  # half of what RS corrects
        gain_gap = cfo_gap = 0.0
        for p, pay, ok, gain, cfo in results:
            _rpay, rok, est = reference[p]
            sent = self.payloads[p].cpu()
            pay, ok = pay.cpu(), ok.cpu()
            wrong += int((ok & (pay != sent).any(-1)).sum())
            # Bursts the reference decodes with room to spare; near the
            # threshold the program's windowed Viterbi and the reference's
            # full-block one may part, so only these judge a failed CRC.
            clear = rok & (est["rs_corrected"].cpu() <= room)
            lost += int((clear & ~ok).sum())
            sure += int(clear.sum())
            g = est["gain"].to(gain.device)
            gain_gap = max(gain_gap, float(((gain.to(torch.complex128) - g).abs()
                                            / g.abs()).max()))
            cfo_gap = max(cfo_gap, float((cfo.to(torch.float64)
                                          - est["cfo"].to(cfo.device)).abs().max()))
        return {"payload_wrong": wrong, "lost_share": lost / max(sure, 1),
                "gain_gap": gain_gap, "cfo_gap": cfo_gap}

    def _reference(self, q=identity):
        out = {}
        for p in range(self.npool):
            pay, ok, est = burst_rx.decode(self.caps[p], self.link, q)
            out[p] = (pay.cpu(), ok.cpu(), est)
        return out

    def check(self, limits: dict) -> dict:
        """The numbers compared over the sampled calls: CRC-passing payloads
        that differ from what was sent (exact), the share of the bursts
        that the reference decodes with at most half of RS's correction
        used whose CRC the program fails (exact), and the widest relative
        gap of the complex gain and the widest gap of the carrier offset
        from the reference's."""
        results = [(c % self.npool, pay, ok, gain, cfo)
                   for c, pay, ok, gain, cfo in self.sample.taken.values()]
        return self._numbers(results, self._reference())

    def control(self) -> dict:
        """The numbers with the reference receiver computed in bfloat16 in
        the program's place, on every pool batch."""
        reference = self._reference()
        ctrl = self._reference(bf16)
        results = [(p, pay, ok, est["gain"], est["cfo"]) for p, (pay, ok, est) in ctrl.items()]
        return self._numbers(results, reference)
