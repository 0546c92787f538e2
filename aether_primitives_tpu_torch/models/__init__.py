"""Signal-chain models: the streaming receive chain and the burst link."""

from . import modem, packet, sync
from .modem import RxChain, RxChainConfig
from .packet import PacketConfig, PacketModem

__all__ = ["modem", "packet", "sync", "RxChain", "RxChainConfig",
           "PacketConfig", "PacketModem"]
