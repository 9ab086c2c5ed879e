# W2VVPP (the reference's concat model) at the `laff` config's full width on
# the synthetic world of laff_tpu_torch.data.synth: bow, w2v and GRU text
# and the four rehearsal video features, each side concatenated raw and
# projected by one TransformNet into the 4096-d common space (single space,
# no attention), with the towers tied by txt_fc_same_with_vis_fc (the
# '__concat__' tie: one linear for both concatenations). The tie needs both
# concatenations equally wide: 512 + 768 + 2048 + 2048 = 5376 on the video
# side, so the text side's bow vocabulary must have 5376 - 500 - 1024 = 3852
# words, the width build_world(..., n_vocab=3852) gives. bf16 tower compute
# like the rehearsal.

from . import base_config as BaseConfig


class config(BaseConfig.config):
    model_name = 'W2VVPP'
    vid_feats = ['clip_ft', 'timesformer', 'x3d', 'ircsn']
    vis_fc_layers = ['0', 4096]
    txt_fc_layers = '0-4096'
    text_encoding = {
        'bow_encoding': {'name': 'bow_nsw'},
        'w2v_encoding': {'name': 'w2v_nsw'},
        'rnn_encoding': {'name': 'gru_mean'},
        'bert_encoding': {'name': 'noBert'},
        'CLIP_encoding': {'name': 'noCLIP'},
        'NetVLAD_encoding': {'name': 'noNetVLAD'},
    }
    threshold = 5
    we_dim = 500
    rnn_size = 1024
    batch_norm = True
    dropout = 0.2
    activation = 'tanh'
    optimizer = 'adam'
    lr = 1e-4
    lr_decay_rate = 0.99
    float16 = True
    txt_attention = 'concat'
    vis_attention = 'concat'
    txt_fc_same_with_vis_fc = True
    txt_fc_same_with_vis_fc_dict = {}
    w2v_dir = 'word2vec/synth500'
    eval_batch_size = 1024
