# LAFF-ml headline at full width, with precomputed CLIP text rows: the
# shape of the `laff` config at parm 0_12_0_12_0_0_1 (bow/w2v/gru/clip text
# + 4 video features -> common 4096, 8-head LAFF gate, attention index 12),
# bf16 tower compute like the reference's AMP headline config. Its world is
# built by laff_tpu_torch.data.synth (same layout and widths as
# shell/make_rehearsal_world.py): CLIP text rows are precomputed in
# TextData/clip_synth like the reference's dumps (data_provider.py:565-574).

from . import base_config as BaseConfig


class config(BaseConfig.config):
    model_name = 'LAFF'
    vid_feats = ['clip_ft', 'timesformer', 'x3d', 'ircsn']
    vis_fc_layers = ['0', 4096]
    txt_fc_layers = '0-4096'
    text_encoding = {
        'bow_encoding': {'name': 'bow_nsw'},
        'w2v_encoding': {'name': 'w2v_nsw'},
        'rnn_encoding': {'name': 'gru_mean'},
        'bert_encoding': {'name': 'noBert'},
        'CLIP_encoding': {'name': 'ViT-B/32', 'dir_name': 'clip_synth'},
        'NetVLAD_encoding': {'name': 'noNetVLAD'},
    }
    clip_opt = {
        'size': 512, 'transform_batch_norm': True, 'transform_dropout': 0.0,
        'transform_activation': 'tanh', 'frozen': True, 'vocab_size': 49408,
    }
    txt_no_transform = ['CLIP_encoder']
    threshold = 5
    we_dim = 500
    rnn_size = 1024
    batch_norm = True
    dropout = 0.2
    activation = 'tanh'
    optimizer = 'adam'
    lr = 1e-4
    lr_decay_rate = 0.99
    float16 = True  # bf16 compute, matching the AMP headline config
    multi_head_attention = {'dropout': 0.0, 'heads': 8,
                            'embed_dim_qkv': 4096 // 8}
    attention_param_each_head = {'with_ave': False, 'mul': False,
                                 'split_head': True}
    txt_attention = BaseConfig.ATTENTION_TYPES[12]
    vis_attention = BaseConfig.ATTENTION_TYPES[12]
    w2v_dir = 'word2vec/synth500'
    eval_batch_size = 1024
