# Tiny FrameLAFF config for end-to-end tests (frame features 'clip_frames').
from .tiny import config_frame as config  # noqa: F401
