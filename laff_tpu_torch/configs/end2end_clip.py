# End2EndClip: raw frames + raw text through live CLIP towers (reference
# model/model.py:2261-2498; the reference ships no config for it: this is
# laff_tpu's ViT-B/32 setup, laff_tpu/configs/end2end_clip.py).
from . import base_config as BaseConfig


class config(BaseConfig.config):
    model_name = 'End2EndClip'
    frame_loader = True
    sample_frame = 8
    frame_sample_type_train = 'random'
    frame_sample_type_test = 'uniform'
    clip_opt = {
        'size': 512, 'transform_batch_norm': False, 'transform_dropout': 0.0,
        'transform_activation': 'tanh', 'frozen': False, 'vocab_size': 49408,
    }
    optimizer = 'adam'
    lr = 1e-5
    margin = 0.2
    direction = 't2i'
    max_violation = True
    # ViT-B/32 tower dims (overridable for tests / smaller towers)
    clip_text_config = {}
    clip_vision_config = {}
