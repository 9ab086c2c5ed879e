from .feed import EvalFeed, PairFeed, Prefetcher, TextBatcher, VisBatcher
from .sources import TextSource, VisionSource, read_video_set, vis_id_of

__all__ = [
    "EvalFeed",
    "PairFeed",
    "Prefetcher",
    "TextBatcher",
    "VisBatcher",
    "TextSource",
    "VisionSource",
    "read_video_set",
    "vis_id_of",
]
