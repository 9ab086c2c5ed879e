# FrameLAFF (the LAFF-ml headline) at full width on the synthetic world of
# laff_tpu_torch.data.synth (build_world(..., frame_feat=True)): the shape of
# FrameLaff_NoFrameFc_StrongCLIP_adjust at parm 0_7_1_12_0_12_0 with the
# world's names. Video tower: one frame feature (512-d rows under
# FeatureData/frame/clip_frames, at most max_frame 50 a video) pooled by the
# plain single-head gate (attention index 7), no frame fc, BN-only
# passthrough tiled to 4096, beside c3d 2048, timesformer 768, x3d 2048 and
# ircsn 2048 (frame_feat_with_video_feat): L = 5 locals fused by the 8-head
# LAFF gate (index 12). Text tower: bow, w2v, GRU-mean and precomputed CLIP
# text rows (TextData/clip_synth), fused by index 12. Common space 4096,
# bf16 towers, dropout 0.2. No raw video frames and no live tower.
# 91,225,805 parameters: the `rehearsal` config's 84,925,644 less clip_ft's
# 512 -> 4096 projection (2,101,248; its BatchNorm stays, on the tiled frame
# feature), plus c3d's 2048 -> 4096 projection and BatchNorm (8,400,896) and
# the frame gate's Linear(512, 1) (513).

from . import base_config as BaseConfig
from . import rehearsal


class config(rehearsal.config):
    model_name = 'FrameLAFF'
    vid_feats = ['c3d', 'timesformer', 'x3d', 'ircsn']
    frame_feat_input = True
    vid_frame_feats = ['clip_frames']
    max_frame = 50
    vis_frame_attention = BaseConfig.ATTENTION_TYPES[7]
    vis_frame_addFC = False
    frame_feat_with_video_feat = True
    vis_no_transform = ['clip_frames']
    vis_attention_global_decay_rate = 0.0
    txt_attention_global_decay_rate = 0.0
