# LAFF headline config (reference configs/laff.py). Reproduction parm
# string: 0_12_0_12_0_0_1 (shell/do_laff_mvtest3k.sh:23).

import numpy as np

from . import base_config as BaseConfig


class config(BaseConfig.config):
    model_name = 'LAFF'
    dropout = 0.2
    activation = 'tanh'
    vis_fc_layers = ['0', 4096]
    txt_fc_layers = '0-4096'

    text_encoding = {
        'bow_encoding': {'name': 'bow_nsw'},
        'w2v_encoding': {'name': 'w2v_nsw'},
        'rnn_encoding': {'name': 'gru_mean'},
        'bert_encoding': {'name': 'noBert', 'dir_name': 'bert-base-uncased'},
        'CLIP_encoding': {'name': 'noCLIP',
                          'dir_name': 'clip_finetune_8frame_uniform_1103'},
        'NetVLAD_encoding': {'name': 'noNetVLAD'},
    }

    bert_size = 768
    bert_frozen = True
    bert_do_lower_case = True
    bert_transform_batch_norm = True
    bert_transform_dropout = 0
    bert_transform_activation = 'tanh'

    clip_opt = {
        'size': 512, 'transform_batch_norm': True, 'transform_dropout': 0.0,
        'transform_activation': 'tanh', 'frozen': True, 'vocab_size': 49408,
    }

    attention_param_each_head = {'with_ave': True, 'mul': False, 'split_head': True}
    multi_head_attention = {'dropout': 0.0, 'heads': 8, 'embed_dim_qkv': 4096 // 8}
    vis_attention_global_decay_rate = 0.8
    txt_attention_global_decay_rate = 0.8
    vis_no_transform = ['clip_finetune_8frame_uniform_1103']
    txt_no_transform = ['CLIP_encoder']

    # sweep decode: <vid_feats>_<vis_attn>_<txt_enc>_<txt_attn>_<with_ave>_<mul>_<split_head>
    def adjust_parm(self, value):
        vid_feats = [
            'clip_finetune_8frame_uniform_1103', 'mean_resnext101_resnet152',
            'mean_C3d_resneXt101_16f', 'mean_resnext101_32x48d_wsl,avgpool,os',
            'mean_pyresnext-101_rbps13k,flatten0_output,os',
            'HowTo100M_TimeSformer_divST_96x4_224',
            'X3D_L', 'mean_irCSN_152_ig65m_from_scratch',
        ]
        vid_feats_iterlist = [
            np.array([0, 5, 6, 7]),  # clip-ft + timesformer + x3d + ircsn
        ]
        text_encodings = [
            ['bow_nsw', 'w2v_nsw', 'gru_mean', 'noBert', 'ViT-B/32', 'noNetVLAD'],
        ]
        a = [int(x) for x in value.split('_')]
        self.vid_feats = list(np.array(vid_feats)[vid_feats_iterlist[a[0]]])
        self.vis_attention = self.vis_attentions[a[1]]
        for i, key in enumerate(self.text_encoding):
            self.text_encoding[key]['name'] = text_encodings[a[2]][i]
        self.txt_attention = self.txt_attentions[a[3]]
        self.attention_param_each_head['with_ave'] = a[4] == 1
        self.attention_param_each_head['mul'] = a[5] == 1
        self.attention_param_each_head['split_head'] = a[6] == 1
