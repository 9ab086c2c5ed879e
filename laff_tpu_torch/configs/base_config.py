# Base experiment config. Attribute names and the attention index table are
# a public contract shared with the reference (configs/base_config.py:3-277):
# shell sweeps address attention types by index and checkpoints pickle these
# objects, so the surface must match even though the runtime consuming it is
# a different (PyTorch/CUDA) stack.

ATTENTION_TYPES = (
    'attention_noAverageMul_Ave',          # 0: gate + mean residual, no mul
    'average_AverageMul_noAve',            # 1: gate on local*mean, no residual
    'con_attention',                       # 2
    'fc_attention',                        # 3
    'just_average',                        # 4
    'muti_head_attention',                 # 5
    'attention3',                          # 6
    'attention_noAveNoAverageMul',         # 7: plain gate
    'concat',                              # 8: w2vvpp-style concatenation
    'attention_averageMul',                # 9: gate on local*mean + residual
    'muti_head_attention_official',        # 10
    'my_self_attention',                   # 11
    'Multi_head_MyApply_Attention',        # 12: LAFF multi-head gate
    'Multi_head_MyApply_FusionAttention',  # 13
    'Multi_head_Attention_layer_norm',     # 14
    'Multi_head_Attention_distinct_fc',    # 15
    'Attention_MMT',                       # 16
)


class config(object):

    def adjust_parm(self, value):
        pass

    def get_txt_encoder_num(self, text_encoding):
        return sum(
            1 for name in text_encoding
            if 'no' not in text_encoding[name]['name']
        )

    model_name = 'w2vpp_mutivis_attention'

    text_encoding = {
        'bow_encoding': {'name': 'bow_nsw'},
        'w2v_encoding': {'name': 'w2v_nsw'},
        'rnn_encoding': {'name': 'gru_mean'},
        'bert_encoding': {'name': 'noBert', 'dir_name': 'bert-base-uncased'},
        'CLIP_encoding': {'name': 'noCLIP', 'dir_name': 'CLIP_ViT-B32'},
        'NetVLAD_encoding': {'name': 'noNetVLAD'},
    }
    preprocess_type = 'clip'
    text_encoder_num = 3
    threshold = 5
    bow_norm = 0
    we_dim = 500
    # GRU embedding w2v init is gated on we_dim == 500 like the reference
    # (model/model.py:334-336); set True/False to force it on other widths
    # (None = reference behavior)
    w2v_init_rnn = None
    rnn_size = 1024
    rnn_layer = 1
    txt_fc_layers = '0-2048'
    txt_norm = 2

    # text-encoder transform options
    bert_size = 768
    bert_frozen = False
    bert_do_lower_case = True
    bert_transform_batch_norm = True
    bert_transform_dropout = 0
    bert_transform_activation = 'tanh'
    clip_opt = {
        'size': 512, 'transform_batch_norm': False, 'transform_dropout': 0.0,
        'transform_activation': 'tanh', 'frozen': True, 'vocab_size': 49408,
    }
    NetVLAD_opt = {'num_clusters': 32, 'alpha': 100, 'normalize_pooling': False}

    # visual transform
    vis_fc_layers = ['0', 2048]
    vis_norm = 2
    use_abs = False
    batch_norm = False
    batch_norm_momentum = 0.1
    batch_norm_eps = 1e-05
    dropout = 0.2
    last_dropout = 0.2
    activation = 'tanh'
    last_activation = 'tanh'

    # loss
    loss = 'mrl'
    margin = 0.2
    direction = 't2i'
    max_violation = True
    cost_style = 'sum'
    measure = 'cosine'

    # optimizer
    optimizer = 'rmsprop'
    lr = 0.0001
    lr_decay_rate = 0.99
    grad_clip = 2

    # bfloat16 compute for the device towers (reference float16/AMP flag)
    float16 = False

    # attention
    attention_types = ATTENTION_TYPES
    attention_l2norm = False
    muti_head_attention_official = {'agg': 'mean'}
    vis_attentions = ATTENTION_TYPES

    vis_no_transform = []
    txt_no_transform = []

    my_self_attention_output_types = [
        'mean', 'max', 'first', 'last', 'cls_embedding', 'concat',
        'max_embedding', 'mean_embedding', 'random', 'second', 'third',
        'Attention_1',
    ]
    my_self_attention_output_type = 'mean'

    txt_attentions = ATTENTION_TYPES
    txt_attention = ATTENTION_TYPES[1]
    txt_attention_global_decay_rate = 0.8
    txt_expert_embedding = {'expert': False, 'l2norm': False}

    vid_feats = [
        'mean_resnext101_resnet152', 'irCSN_152_ig65m_16frms',
        'mean_pyresnext-101_rbps13k,flatten0_output,os', 'ipcsn_sports1m_32frms',
        'mean_C3d_resneXt101_16f', 'mean_resnext101_32x48d_wsl,avgpool,os',
        'mean_clip_frame_feat_ViT-B_32,os', 'HowTo100M_TimeSformer_divST_96x4_224',
        'X3D_L', 'I3D_NLN_8x8_R50',
    ]
    vis_feat_add_concat = False
    vis_attention = ATTENTION_TYPES[1]
    vis_attention_global_decay_rate = 0.8
    vis_expert_embedding = {'expert': False, 'l2norm': False}

    multi_head_attention = {'dropout': 0.0, 'heads': 4, 'embed_dim_qkv': 2048 // 4}
    attention_param_each_head = {'with_ave': True, 'mul': False, 'split_head': True}
    multi_space = True

    # frame-level features (FrameLAFF)
    max_frame = 200
    frame_feat_input = False
    frame_feat_with_video_feat = False
    vid_frame_feats = [
        'pyresnext-101_rbps13k,flatten0_output,os+pyresnet-152_imagenet11k,flatten0_output,os',
    ]
    vis_frame_attention = ATTENTION_TYPES[1]
    vis_frame_addFC = True

    # task2 (concept space)
    task2 = False
    txt_feature_task2 = 'bow'
    txt_fc_layers_task2 = '0-0'
    text_encoding_task2 = 'bow_nsw'
    threshold_task2 = 5
    bow_norm_task2 = 0
    batch_norm_task2 = True
    activation_task2 = 'sigmoid'
    dropout_task2 = 0.1
    vis_fc_layers_task2 = '0-0'

    # task3 (negation)
    task3_start = -1
    task3_loss_weight = 1
    task3_margin = 0.2
    loss_lambda = 0.2
    measure_task2 = 'hist'
    alpha = 0.2
    negative = False
    kl = False
    mask = False
    origin_vid_feats = None
    origin_text_feats = None
    task3_end = 100
    task3_neg_weight = 1
    task3_neg_retrival_weight = 0.001
    task3_bottommargin = 0.1
    task3_uppermargin = 0.6
    task3_bottommargin_t2t = 0.1
    task3_uppermargin_t2t = 0.3
    max_txtlength = 77

    # end-to-end frame loading
    frame_loader = False
    frame_sample_type_train = 'random'
    frame_sample_type_test = 'uniform'
    sample_frame = 8

    txt_fc_same_with_vis_fc = False
    txt_fc_same_with_vis_fc_dict = {}
    skip_feature = {'visual': None, 'text': None}

    # port-specific knobs (no reference counterpart)
    eval_batch_size = 1024
    device_batch_multiple = 1  # pad batch to a multiple (mesh divisibility)
