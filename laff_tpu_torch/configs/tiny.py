# Tiny LAFF-ml config for smoke tests and synthetic-collection runs.
# Expects features 'clip_ft'/'x3d' and a toy word2vec at <root>/word2vec/toy.

from . import base_config as BaseConfig


class config(BaseConfig.config):
    model_name = 'LAFF'
    vid_feats = ['clip_ft', 'x3d']
    vis_fc_layers = ['0', 32]
    txt_fc_layers = '0-32'
    text_encoding = {
        'bow_encoding': {'name': 'bow_nsw'},
        'w2v_encoding': {'name': 'w2v_nsw'},
        'rnn_encoding': {'name': 'gru_mean'},
        'bert_encoding': {'name': 'noBert'},
        'CLIP_encoding': {'name': 'noCLIP'},
        'NetVLAD_encoding': {'name': 'noNetVLAD'},
    }
    threshold = 1
    threshold_task2 = 1
    we_dim = 8
    rnn_size = 8
    batch_norm = True
    dropout = 0.2
    optimizer = 'adam'
    lr = 2e-3
    lr_decay_rate = 0.99
    multi_head_attention = {'dropout': 0.0, 'heads': 4, 'embed_dim_qkv': 8}
    attention_param_each_head = {'with_ave': False, 'mul': False, 'split_head': True}
    txt_attention = BaseConfig.ATTENTION_TYPES[12]
    vis_attention = BaseConfig.ATTENTION_TYPES[12]
    w2v_dir = 'word2vec/toy'
    max_frame = 6
    eval_batch_size = 64


class config_frame(config):
    """Tiny FrameLAFF variant (frame features named 'clip_frames')."""
    model_name = 'FrameLAFF'
    frame_feat_input = True
    vid_frame_feats = ['clip_frames']
    vis_frame_attention = BaseConfig.ATTENTION_TYPES[7]
    vis_frame_addFC = False
    frame_feat_with_video_feat = True
