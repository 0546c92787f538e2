"""Signal-chain models: the streaming receive chain, the burst link, the
channelizers (waterfall, PFB, STFT) and the digital down/up-converters."""

from . import channelizer, ddc, modem, packet, sync
from .channelizer import (
    Channelizer, PfbChannelizer, PfbChannelizerOs, PfbSynthesizer, PfbSynthesizerOs,
)
from .ddc import Ddc, DdcConfig, Duc, DucConfig, ddc_bank
from .modem import RxChain, RxChainConfig
from .packet import PacketConfig, PacketModem

__all__ = ["channelizer", "ddc", "modem", "packet", "sync", "RxChain", "RxChainConfig",
           "PacketConfig", "PacketModem", "Channelizer", "PfbChannelizer",
           "PfbChannelizerOs", "PfbSynthesizer", "PfbSynthesizerOs", "Ddc",
           "DdcConfig", "Duc", "DucConfig", "ddc_bank"]
