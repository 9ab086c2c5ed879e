from .feed import EvalFeed, PairFeed, Prefetcher, TextBatcher, VisBatcher, host_cast_bf16
from .sources import TextSource, VisionSource, read_video_set, vis_id_of

__all__ = [
    "EvalFeed",
    "PairFeed",
    "Prefetcher",
    "TextBatcher",
    "VisBatcher",
    "host_cast_bf16",
    "TextSource",
    "VisionSource",
    "read_video_set",
    "vis_id_of",
]
