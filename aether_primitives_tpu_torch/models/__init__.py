"""Signal-chain models: the streaming receive chain."""

from . import modem
from .modem import RxChain, RxChainConfig

__all__ = ["modem", "RxChain", "RxChainConfig"]
