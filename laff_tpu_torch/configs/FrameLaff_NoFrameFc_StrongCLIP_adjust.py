# FrameLAFF (LAFF-ml headline) config (reference
# configs/FrameLaff_NoFrameFc_StrongCLIP_adjust.py). Reproduction parm
# string: 0_7_1_12_0_12_0 (shell/do_laffml_mvtest3k.sh:14,24).

import numpy as np

from . import base_config as BaseConfig


class config(BaseConfig.config):
    model_name = 'FrameLAFF'
    dropout = 0.2
    activation = 'tanh'
    batch_norm = True
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

    clip_opt = {
        'size': 512, 'transform_batch_norm': True, 'transform_dropout': 0.0,
        'transform_activation': 'tanh', 'frozen': True,
    }
    float16 = True

    max_frame = 50
    frame_feat_input = True
    vid_frame_feats = ['clip_frame_feat_ViT-B_32,os']
    vis_frame_attention = BaseConfig.ATTENTION_TYPES[1]

    attention_param_each_head = {'with_ave': False, 'mul': False, 'split_head': True}
    multi_head_attention = {'dropout': 0.0, 'heads': 8, 'embed_dim_qkv': 4096 // 8}
    vid_feats = ['mean_clip_frame_feat_ViT-B_32,os']
    frame_feat_with_video_feat = True
    vis_attention_global_decay_rate = 0.0
    txt_attention_global_decay_rate = 0.0
    vis_no_transform = ['clip_finetune_8frame_uniform_1103', 'clip_frame_feat_ViT-B_32,os']
    txt_no_transform = ['CLIP_encoder']
    vis_frame_addFC = False

    # sweep decode:
    # <frame_feat>_<frame_attn>_<txt_enc>_<txt_attn>_<vid_feats>_<vis_attn>[_unused]
    def adjust_parm(self, value):
        vid_frame_feats = [
            'Frame_clip_finetune_8frame_uniform_1103',
            'clip_frame_feat_ViT-B_32,os',
        ]
        clip_precal_feats = ['clip_finetune_8frame_uniform_1103', 'CLIP_ViT-B32']
        frame_iterlist = [np.array([0]), np.array([1])]
        text_encodings = [
            ['nobow_nsw', 'now2v_nsw', 'nogru_mean', 'noBert', 'ViT-B/32', 'noNetVLAD'],
            ['bow_nsw', 'w2v_nsw', 'gru_mean', 'noBert', 'ViT-B/32', 'noNetVLAD'],
            ['bow_nsw', 'w2v_nsw', 'nogru_mean', 'noBert', 'ViT-B/32', 'noNetVLAD'],
        ]

        a = [int(x) for x in value.split('_')]
        self.vid_frame_feats = list(np.array(vid_frame_feats)[frame_iterlist[a[0]]])
        self.vis_no_transform = list(np.array(vid_frame_feats)[frame_iterlist[a[0]]])
        self.text_encoding['CLIP_encoding']['dir_name'] = clip_precal_feats[a[0]]
        self.vis_frame_attention = self.attention_types[a[1]]
        for i, key in enumerate(self.text_encoding):
            self.text_encoding[key]['name'] = text_encodings[a[2]][i]
        self.txt_attention = self.txt_attentions[a[3]]

        vid_feats = [
            'mean_clip_frame_feat_ViT-B_32,os', 'mean_resnext101_resnet152',
            'mean_C3d_resneXt101_16f', 'mean_resnext101_32x48d_wsl,avgpool,os',
            'mean_pyresnext-101_rbps13k,flatten0_output,os',
            'HowTo100M_TimeSformer_divST_96x4_224',
            'X3D_L', 'mean_irCSN_152_ig65m_from_scratch',
            'random_feat_512', 'full_1_feat_512',
            'mean_pyresnet-152_imagenet11k,flatten0_output,os',
        ]
        vid_iterlist = [
            np.array([2, 5, 6, 7]),  # c3d + timesformer + x3d + ircsn
            np.array([4, 2, 3, 7]),  # 101 + c3d + wsl + ircsn
        ]
        self.vid_feats = list(np.array(vid_feats)[vid_iterlist[a[4]]])
        self.vis_attention = self.attention_types[a[5]]
