"""Faults planted under the timed path, to show that the comparison which
decides ``correct`` catches them (the tests, and ``control.py --faults`` on
the card). Each patches the port's entry point in this process only.

- ``state_unchanged``: ``RxChain.streaming_step`` hands back the state it
  was given.
- ``half_batch``: half of the batch is left out and the kept half's
  outputs stand in for it (the RX chain: the second half of each block;
  the burst link: the second half of the captures).
- ``answer_altered``: one bit of each step's or call's output is flipped
  where it is produced (a burst's payload keeps its CRC flag).
- ``crc_failed``: the burst link returns every CRC flag false.
"""

from __future__ import annotations

import contextlib

import torch

NAMES = ("state_unchanged", "half_batch", "answer_altered", "crc_failed")


@contextlib.contextmanager
def planted(name: str):
    from aether_primitives_tpu_torch.models import modem, packet

    rx_step, rx_batch = modem.RxChain.streaming_step, packet.PacketModem.rx_batch

    def step_state(self, block, state):
        bits, _new = rx_step(self, block, state)
        return bits, state

    def step_half(self, block, state):
        n = block.shape[-1] // 2
        bits, new = rx_step(self, block[..., :n].contiguous(), state)
        return torch.cat([bits, bits], dim=-1), new

    def step_altered(self, block, state):
        bits, new = rx_step(self, block, state)
        bits = bits.clone()
        bits.view(-1)[0] ^= 1
        return bits, new

    def batch_half(self, captures):
        h = captures.shape[0] // 2
        pay, ok, diag = rx_batch(self, captures[:h])
        return (torch.cat([pay, pay]), torch.cat([ok, ok]),
                {k: torch.cat([v, v]) for k, v in diag.items()})

    def batch_altered(self, captures):
        pay, ok, diag = rx_batch(self, captures)
        pay = pay.clone()
        pay[0, 0] ^= 1
        return pay, ok, diag

    def batch_failed(self, captures):
        pay, ok, diag = rx_batch(self, captures)
        return pay, torch.zeros_like(ok), diag

    table = {
        "state_unchanged": {"streaming_step": step_state},
        "half_batch": {"streaming_step": step_half, "rx_batch": batch_half},
        "answer_altered": {"streaming_step": step_altered, "rx_batch": batch_altered},
        "crc_failed": {"rx_batch": batch_failed},
    }
    if name not in table:
        raise ValueError(f"unknown fault {name!r}")
    patch = table[name]
    try:
        if "streaming_step" in patch:
            modem.RxChain.streaming_step = patch["streaming_step"]
        if "rx_batch" in patch:
            packet.PacketModem.rx_batch = patch["rx_batch"]
        yield
    finally:
        modem.RxChain.streaming_step = rx_step
        packet.PacketModem.rx_batch = rx_batch
