# Tiny LAFF config exercising cross-tower weight tying
# (txt_fc_same_with_vis_fc, reference configs/base_config.py:268-271):
# the w2v text TransformNet shares parameters with the TransformNet of the
# 8-d synthetic vis feature 'w2v_like8'.
from .tiny import config as TinyConfig


class config(TinyConfig):
    vid_feats = ['clip_ft', 'w2v_like8']
    txt_fc_same_with_vis_fc = True
    txt_fc_same_with_vis_fc_dict = {'w2v_encoding': 'w2v_like8'}
