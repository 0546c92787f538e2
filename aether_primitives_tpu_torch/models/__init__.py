"""Signal-chain models: the loopback modem, the streaming receive and
transmit chains, the channel simulation and BER curves, the burst link, the
channelizers (waterfall, PFB, STFT) and the digital down/up-converters."""

from . import ber, channel, channelizer, ddc, modem, packet, sync
from .channel import Channel, ChannelConfig
from .sync import OfdmEqualizer
from .channelizer import (
    Channelizer, PfbChannelizer, PfbChannelizerOs, PfbSynthesizer, PfbSynthesizerOs,
)
from .ddc import Ddc, DdcConfig, Duc, DucConfig, ddc_bank
from .modem import (
    Modem, ModemConfig, RxChain, RxChainConfig, TxChain, loopback_delay, pad_to_frames,
)
from .packet import PacketConfig, PacketModem

__all__ = ["ber", "channel", "channelizer", "ddc", "modem", "packet", "sync", "Modem",
           "ModemConfig", "TxChain", "loopback_delay", "Channel", "ChannelConfig", "OfdmEqualizer",
           "RxChain", "RxChainConfig",
           "PacketConfig", "PacketModem", "Channelizer", "PfbChannelizer",
           "PfbChannelizerOs", "PfbSynthesizer", "PfbSynthesizerOs", "Ddc",
           "DdcConfig", "Duc", "DucConfig", "ddc_bank", "pad_to_frames"]
