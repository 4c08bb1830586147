from .decoder import ClsRegBranch, Decoder, DecoderBlock
from .encoder import Encoder, EncoderBlock
from .mini_detector import ConvBnStack, MiniDetector
from .model import DESTR, build_destr
from .pair_attention import get_pairs, pair_self_attention

__all__ = [
    "ClsRegBranch",
    "ConvBnStack",
    "DESTR",
    "Decoder",
    "DecoderBlock",
    "Encoder",
    "EncoderBlock",
    "MiniDetector",
    "build_destr",
    "get_pairs",
    "pair_self_attention",
]
