# Tiny End2EndClip config for tests (small towers, CPU-friendly; the
# repository's configs/e2e_tiny.py for laff_tpu).
from .end2end_clip import config as _base


class config(_base):
    sample_frame = 2
    lr = 5e-4
    clip_text_config = dict(vocab_size=49408, context_length=16, width=32,
                            heads=2, layers=1, embed_dim=16)
    clip_vision_config = dict(image_size=32, patch_size=16, width=32,
                              heads=2, layers=1, embed_dim=16)
