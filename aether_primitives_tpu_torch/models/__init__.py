"""Signal-chain models: the loopback modem, the streaming receive and
transmit chains, the channel simulation and BER curves, the burst link, the
channelizers (waterfall, PFB, STFT), the digital down/up-converters, the
tracking loops (``sync``), the CPFSK/GMSK and OQPSK modems (``fsk``), the
detectors (``detect``), CP-OFDM (``ofdm``), the chirp modem (``css``),
acquisition by cross-ambiguity (``caf``), direction finding and
beamforming (``doa``), modulation classification (``amc``), frequency
hopping (``fhss``), the adaptive equalizers (``equalizer``) and diversity
combining and MIMO detection (``diversity``)."""

from . import (
    amc, ber, caf, channel, channelizer, css, ddc, detect, diversity, doa, equalizer, fhss,
    fsk, modem, ofdm, packet, sync,
)
from .css import CssConfig, CssModem
from .ofdm import OfdmConfig, OfdmModem, cp_sync
from .fsk import FskConfig, FskModem
from .channel import Channel, ChannelConfig
from .sync import OfdmEqualizer, detect_preamble
from .channelizer import (
    Channelizer, PfbChannelizer, PfbChannelizerOs, PfbSynthesizer, PfbSynthesizerOs,
    istft, pfb_channelize, pfb_channelize_os, pfb_prototype, pfb_prototype_nyquist,
    pfb_synthesis_taps, pfb_synthesize, pfb_synthesize_os, sharded_pfb_os, stft, welch_psd,
)
from .ddc import Ddc, DdcConfig, Duc, DucConfig, ddc_bank, sharded_ddc, sharded_duc
from .modem import (
    Modem, ModemConfig, RxChain, RxChainConfig, TxChain, loopback_delay, pad_to_frames,
)
from .packet import PacketConfig, PacketModem

__all__ = ["ber", "channel", "channelizer", "ddc", "modem", "packet", "sync", "Modem",
           "ModemConfig", "TxChain", "loopback_delay", "Channel", "ChannelConfig", "OfdmEqualizer",
           "detect_preamble", "RxChain", "RxChainConfig",
           "PacketConfig", "PacketModem", "Channelizer", "PfbChannelizer",
           "PfbChannelizerOs", "PfbSynthesizer", "PfbSynthesizerOs", "welch_psd",
           "pfb_channelize", "pfb_prototype", "pfb_synthesis_taps", "pfb_synthesize",
           "pfb_channelize_os", "pfb_prototype_nyquist", "pfb_synthesize_os", "sharded_pfb_os",
           "stft", "istft", "Ddc", "DdcConfig", "Duc", "DucConfig", "ddc_bank", "sharded_ddc",
           "sharded_duc", "pad_to_frames", "detect", "fsk", "FskConfig", "FskModem",
           "amc", "caf", "css", "diversity", "doa", "equalizer", "ofdm", "fhss", "OfdmConfig",
           "OfdmModem", "cp_sync", "CssConfig", "CssModem"]
