"""Config -> text featurizers, model spec, feeds, and a seeded model.

The parts of ``laff_tpu.engine.prepare`` that prediction and training
need: ``load_config``, ``build_featurizers`` (BoW / w2v / GRU ids / BERT
tokens or rows / precomputed CLIP, in the reference's encoder order),
``build_spec``, the trainer's ``Options`` and ``prepare`` (``train_strategy`` 'usual' or
'subset', an optional ``trainCollection2``, the indexed text feed of
``device_text_featurize``), and ``init_checkpoint``, which seeds a model for
a collection as the trainer does before its first step. Vocabularies are
built from the train captions when their pickle is missing, and saved in
the reference layout.

FrameLAFF configs (``frame_feat_input``) open their frame BigFiles from
``FeatureData/frame/<name>`` of each collection (train, validation,
``trainCollection2``) and feed them padded to ``max_frame``.

The auxiliary tasks: ``task3_caption`` opens the train collection's
false-caption set ``<train>.caption.<task3_caption>.txt`` for the feed and
names the validation negation set ``<val>.caption.negationset.txt``;
``prepare_task2`` builds task2's concept labels and spec (inert without
``task2_intended``).

Options of ``laff_tpu`` that the port does not have yet raise
``NotImplementedError`` naming the ROADMAP item that brings them; none is
silently ignored.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..data import PairFeed, TextBatcher, TextSource, VisBatcher, VisionSource, read_video_set
from ..models.bert import BertTokensFeaturizer, LiveBertTextFeaturizer, import_bert_params
from ..models.laff import LAFFModel
from ..models.spec import (AttentionSpec, BertSpec, GruSpec, LAFFSpec, Task2Spec, Task3Spec,
                           TowerSpec, TransformSpec)
from ..store import BigFile
from ..text import build_vocab, get_txt2vec
from ..text.txt2vec import IndexVec, load_vocab_pickle
from ..text.vocab import save_vocab
from ..utils import ROOT_PATH, get_logger, makedirs

logger = get_logger(__name__)

# reference encoder-module names -> feature keys
_ENCODER_ALIASES = {
    "rnn_encoder": "rnn",
    "bert_encoder": "bert",
    "bow_encoder": "bow",
    "w2v_encoder": "w2v",
    "CLIP_encoder": "clip",
    "NetVLAD_encoder": "netvlad",
}


def load_config(config_name: str, parm_adjust_config: str = "None"):
    """Instantiate ``laff_tpu_torch.configs.<name>.config`` and apply the
    sweep string, as the trainer does."""
    module = importlib.import_module(f"laff_tpu_torch.configs.{config_name}")
    config = module.config()
    # adjust_parm mutates dict attributes in place: give this instance its
    # own copies so the class defaults stay as written
    for name in dir(config):
        value = getattr(config, name)
        if not name.startswith("_") and isinstance(value, (dict, list)):
            setattr(config, name, copy.deepcopy(value))
    if parm_adjust_config != "None":
        config.adjust_parm(parm_adjust_config)
    return config


def w2v_dir_for(rootpath: str, config) -> str:
    """The word2vec dump: the reference's fixed vec500flickr30m layout, with
    the config's ``w2v_dir`` as fallback."""
    w2v_dir = os.path.join(rootpath, "word2vec", "flickr", "vec500flickr30m")
    if not os.path.exists(w2v_dir):
        alt = getattr(config, "w2v_dir", None)
        if alt and os.path.exists(os.path.join(rootpath, alt)):
            w2v_dir = os.path.join(rootpath, alt)
    return w2v_dir


def get_we(vocab, w2v_dir: str, rng: np.random.Generator) -> np.ndarray:
    """GRU word-embedding init: U(-1, 1) overwritten with the w2v rows
    where the word has one (reference ``model/model.py:30-48``)."""
    w2v = BigFile(w2v_dir)
    words = [vocab[i] for i in range(len(vocab))]
    we = rng.uniform(low=-1.0, high=1.0, size=(len(vocab), w2v.ndims))
    found, vecs = w2v.gather(words)
    for name, vec in zip(found, vecs):
        we[vocab.find(name)] = vec
    return we.astype(np.float32)


def _ensure_vocab(rootpath, collection, encoding, threshold, capfile, dirname="vocab"):
    path = os.path.join(rootpath, collection, "TextData", dirname,
                        f"{encoding}_{threshold}.pkl")
    if os.path.exists(path):
        return load_vocab_pickle(path)
    logger.info("vocab %s missing; building from %s", path, capfile)
    vocab, _ = build_vocab(capfile, encoding, threshold=threshold)
    save_vocab(vocab, path)
    return vocab


def text_precomputed(config, capfile: str) -> Dict[str, BigFile]:
    """Precomputed text-feature BigFiles next to the caption file
    (reference ``data_provider.py:565-574``)."""
    out = {}
    tdir = os.path.dirname(capfile)
    for enc_name, enc in config.text_encoding.items():
        if enc["name"].startswith(("no", "No")):
            continue
        if enc_name in ("CLIP_encoding", "bert_encoding") and "dir_name" in enc:
            path = os.path.join(tdir, enc["dir_name"])
            if os.path.exists(path):
                out[enc_name] = BigFile(path)
    return out


def bert_tokens_featurizer(config) -> BertTokensFeaturizer:
    """The in-graph BERT tower's tokenizer, as the config names it."""
    return BertTokensFeaturizer(config.text_encoding["bert_encoding"]["name"],
                                do_lower_case=getattr(config, "bert_do_lower_case", True),
                                max_length=getattr(config, "bert_max_length", 64),
                                vocab_file=getattr(config, "bert_vocab_file", ""))


def build_featurizers(config, rootpath: str, vocab_collection: str, train_capfile: str,
                      device="cuda"):
    """Text featurizer bank for the feed and the text-tower feature dims,
    in the reference's encoder order (rnn, bert, bow, w2v, clip, netvlad).
    'bert' is the in-graph tower's tokenizer (``bert_frozen=False``), a
    frozen tower of a local checkout on ``device`` (its pooler rows), or
    the precomputed rows (None), as ``laff_tpu`` chooses.
    Returns (featurizers, txt_dims, gru_spec, gru_vocab, w2v_dir)."""
    txt_dims: Dict[str, int] = {}
    featurizers: Dict[str, object] = {}
    gru_spec = gru_vocab = None
    te = config.text_encoding
    rnn_encoding, pooling = te["rnn_encoding"]["name"].split("_", 1)
    w2v_dir = w2v_dir_for(rootpath, config)

    if rnn_encoding in ("gru", "bigru"):
        gru_vocab = _ensure_vocab(rootpath, vocab_collection, "gru",
                                  config.threshold, train_capfile)
        featurizers["rnn"] = IndexVec(gru_vocab)
        txt_dims["rnn"] = config.rnn_size * (2 if rnn_encoding == "bigru" else 1)
        gru_spec = GruSpec(
            vocab_size=len(gru_vocab), we_dim=config.we_dim,
            rnn_size=config.rnn_size, rnn_layer=config.rnn_layer,
            pooling=pooling, bidirectional=(rnn_encoding == "bigru"),
        )
    if "no" not in te["bert_encoding"]["name"]:
        txt_dims["bert"] = config.bert_size
        bert_name = te["bert_encoding"]["name"]
        if not getattr(config, "bert_frozen", True):  # the feed ships token ids
            featurizers["bert"] = bert_tokens_featurizer(config)
        elif os.path.isdir(os.path.expanduser(bert_name)):  # frozen, local weights
            featurizers["bert"] = LiveBertTextFeaturizer(
                bert_name, do_lower_case=config.bert_do_lower_case, device=device)
        else:
            featurizers["bert"] = None  # precomputed via TextSource
    bow_encoding = te["bow_encoding"]["name"]
    if "no" not in bow_encoding:
        bow_vocab = _ensure_vocab(rootpath, vocab_collection, bow_encoding,
                                  config.threshold, train_capfile)
        bow = get_txt2vec(bow_encoding)(bow_vocab, norm=config.bow_norm)
        featurizers["bow"] = bow
        txt_dims["bow"] = bow.ndims
    w2v_encoding = te["w2v_encoding"]["name"]
    if "no" not in w2v_encoding:
        w2v = get_txt2vec(w2v_encoding)(w2v_dir)
        featurizers["w2v"] = w2v
        txt_dims["w2v"] = w2v.ndims
    if "no" not in te["CLIP_encoding"]["name"]:
        txt_dims["clip"] = config.clip_opt["size"]
        featurizers["clip"] = None  # precomputed via TextSource
    if "no" not in te["NetVLAD_encoding"]["name"]:
        # per-token w2v vectors, pooled by the tower's NetVLAD
        featurizers["netvlad"] = get_txt2vec("w2v_nsw")(w2v_dir)
        txt_dims["netvlad"] = featurizers["netvlad"].ndims * config.NetVLAD_opt["num_clusters"]
    return featurizers, txt_dims, gru_spec, gru_vocab, w2v_dir


def _attn_spec(config, kind: str) -> AttentionSpec:
    aph = config.attention_param_each_head
    mha = config.multi_head_attention
    return AttentionSpec(
        kind=kind, heads=mha["heads"], with_ave=aph["with_ave"], mul=aph["mul"],
        split_head=aph["split_head"], l2norm_each_head=config.attention_l2norm,
        dropout=mha["dropout"], output_type=config.my_self_attention_output_type,
        agg=config.muti_head_attention_official["agg"],
        embed_dim_qkv=mha["embed_dim_qkv"],
    )


def _no_transform_keys(names) -> Tuple[str, ...]:
    return tuple(_ENCODER_ALIASES.get(n, n) for n in names)


def tied_transforms(config, txt_dims: Dict[str, int],
                    vis_dims: Dict[str, int]) -> Tuple[Tuple[str, str], ...]:
    """``txt_fc_same_with_vis_fc`` / ``_dict`` as (txt feature, vis feature)
    tie pairs (``laff_tpu.engine.prepare._tied_transforms``). Dict keys are
    reference encoder names ('w2v_encoding', 'CLIP_encoder', ...), values
    vis feature names; an empty dict with 'concat' fusion on both towers
    ties the whole concat transform ('__concat__')."""
    if not getattr(config, "txt_fc_same_with_vis_fc", False):
        return ()
    tie_dict = getattr(config, "txt_fc_same_with_vis_fc_dict", {}) or {}
    if not tie_dict:
        if config.txt_attention == "concat" and config.vis_attention == "concat":
            return (("__concat__", "__concat__"),)
        raise ValueError("txt_fc_same_with_vis_fc=True needs txt_fc_same_with_vis_fc_dict "
                         "entries (or concat fusion on both towers)")
    pairs = []
    for enc_key, vis_name in tie_dict.items():
        txt_name = enc_key.split("_")[0].lower()
        if txt_name in ("gru", "bigru"):
            txt_name = "rnn"
        if txt_name not in txt_dims or vis_name not in vis_dims:
            raise ValueError(
                f"txt_fc_same_with_vis_fc is not matching encoder_name_list: ({enc_key} -> "
                f"{txt_name!r}, {vis_name!r}); active txt features {sorted(txt_dims)}, vis "
                f"features {sorted(vis_dims)}")
        pairs.append((txt_name, vis_name))
    return tuple(pairs)


def build_spec(config, vis_dims: Dict[str, int], txt_dims: Dict[str, int],
               gru_spec: Optional[GruSpec],
               frame_dims: Optional[Dict[str, int]] = None, task3: bool = False,
               task2: Optional[Task2Spec] = None) -> LAFFSpec:
    """config + discovered feature dims (``frame_dims``: FrameLAFF's frame
    features) -> frozen LAFFSpec (``laff_tpu.engine.prepare.build_spec``;
    an in-graph BERT tower as its ``BertSpec``). ``task3`` adds the config's negation-loss knobs;
    ``task2`` is the spec ``prepare_task2`` built. The NetVLAD cluster
    count is the config's (``NetVLAD_opt``), whose product with the w2v
    width is the 'netvlad' feature's."""
    frame_dims = frame_dims or {}
    if isinstance(config.txt_fc_layers, str):
        txt_common = int(config.txt_fc_layers.split("-")[1])
    else:
        txt_common = int(config.txt_fc_layers[1])
    vis_common = int(config.vis_fc_layers[1])

    overrides = []
    txt_nt = _no_transform_keys(config.txt_no_transform)
    if "bert" in txt_dims:
        overrides.append(("bert", TransformSpec(
            dim_in=txt_dims["bert"], dim_out=txt_common, fc=True,
            activation=config.bert_transform_activation,
            dropout=config.bert_transform_dropout,
            batch_norm=config.bert_transform_batch_norm)))
    if "clip" in txt_dims:
        co = config.clip_opt
        fc = "clip" not in txt_nt
        overrides.append(("clip", TransformSpec(
            dim_in=txt_dims["clip"], dim_out=txt_common, fc=fc,
            activation=co["transform_activation"] if fc else None,
            dropout=co["transform_dropout"],
            batch_norm=co["transform_batch_norm"])))

    compute_dtype = "bfloat16" if getattr(config, "float16", False) else "float32"
    bert_spec = None
    if "bert" in txt_dims and not getattr(config, "bert_frozen", True):
        kwargs = dict(getattr(config, "bert_config_kwargs", {}) or {})
        bert_spec = BertSpec(
            name_or_path=config.text_encoding["bert_encoding"]["name"],
            hidden_size=config.bert_size, max_length=getattr(config, "bert_max_length", 64),
            do_lower_case=config.bert_do_lower_case,
            config_kwargs=tuple(sorted(kwargs.items())))
    txt = TowerSpec(
        features=tuple(txt_dims.items()), common_dim=txt_common,
        attention=_attn_spec(config, config.txt_attention), no_transform=txt_nt,
        transform_overrides=tuple(overrides),
        expert_embedding=config.txt_expert_embedding["expert"],
        expert_l2norm=config.txt_expert_embedding["l2norm"],
        dropout=config.dropout, batch_norm=config.batch_norm,
        activation=config.activation, gru=gru_spec, bert=bert_spec,
        compute_dtype=compute_dtype, netvlad_clusters=int(config.NetVLAD_opt["num_clusters"]),
    )
    vis = TowerSpec(
        features=tuple(vis_dims.items()), common_dim=vis_common,
        attention=_attn_spec(config, config.vis_attention),
        no_transform=_no_transform_keys(config.vis_no_transform),
        expert_embedding=config.vis_expert_embedding["expert"],
        expert_l2norm=config.vis_expert_embedding["l2norm"],
        dropout=config.dropout, batch_norm=config.batch_norm,
        activation=config.activation, frame_features=tuple(frame_dims.items()),
        frame_attention=(_attn_spec(config, config.vis_frame_attention) if frame_dims
                         else None),
        frame_add_fc=config.vis_frame_addFC,
        frame_feat_with_video_feat=config.frame_feat_with_video_feat,
        feat_add_concat=config.vis_feat_add_concat, compute_dtype=compute_dtype,
    )
    return LAFFSpec(
        txt=txt, vis=vis, tied_transforms=tied_transforms(config, txt_dims, vis_dims),
        multi_space=config.multi_space, measure=config.measure,
        margin=config.margin, direction=config.direction,
        max_violation=config.max_violation, cost_style=config.cost_style,
        loss=config.loss, task2=task2,
        task3=Task3Spec(
            neg_weight=config.task3_neg_weight, bottom_margin=config.task3_bottommargin,
            upper_margin=config.task3_uppermargin,
            bottom_margin_t2t=config.task3_bottommargin_t2t,
            upper_margin_t2t=config.task3_uppermargin_t2t,
            retrieval_weight=config.task3_neg_retrival_weight,
            end_epoch=config.task3_end) if task3 else None,
    )


def vis_feature_dims(rootpath: str, collection: str, config) -> Dict[str, int]:
    return {n: f.ndims for n, f in _vis_files(rootpath, collection, config.vid_feats).items()}


def frame_feature_dims(rootpath: str, collection: str, config) -> Dict[str, int]:
    return {n: f.ndims for n, f in open_frame_files(rootpath, collection, config).items()}


def seeded_model(spec: LAFFSpec, seed: int, we: Optional[np.ndarray] = None) -> LAFFModel:
    """A model with the JAX package's init distributions from ``seed``
    (xavier transforms, torch-default gates and GRU, BatchNorm at its
    identity running stats, BERT at flax's N(0, 0.02)), with ``we`` in the
    GRU embedding if given, and an in-graph BERT tower's weights from its
    ``name_or_path`` when that is a local checkout (``laff_tpu``'s
    ``init_state``; ``bert.imported_from`` names it)."""
    model = LAFFModel(spec)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    if we is not None:
        with torch.no_grad():
            model.txt_net.gru.we.weight.copy_(torch.from_numpy(we))
    if model.txt_net.bert is not None:
        pretrained = import_bert_params(spec.txt.bert.name_or_path)
        if pretrained is not None:
            model.txt_net.bert.load_state_dict(pretrained)
            model.txt_net.bert.imported_from = os.path.expanduser(spec.txt.bert.name_or_path)
    return model


def gru_init_we(config, gru_vocab, w2v_dir: str, rng) -> Optional[np.ndarray]:
    """The w2v rows for the GRU embedding when the reference's gate allows
    them (``we_dim`` 500, or ``config.w2v_init_rnn``), else None."""
    w2v_init = getattr(config, "w2v_init_rnn", None)
    if w2v_init is None:
        w2v_init = config.we_dim == 500
    if (gru_vocab is not None and w2v_init and os.path.exists(w2v_dir)
            and BigFile(w2v_dir).ndims == config.we_dim):
        return get_we(gru_vocab, w2v_dir, rng)
    return None


def init_checkpoint(config_name: str, rootpath: str, collection: str, seed: int,
                    parm_adjust_config: str = "None") -> Dict:
    """A checkpoint payload for a seeded, untrained model over
    ``collection``'s features and caption vocabulary: the state the trainer
    starts from."""
    from .checkpoint import checkpoint_payload

    config = load_config(config_name, parm_adjust_config)
    capfile = os.path.join(rootpath, collection, "TextData", f"{collection}.caption.txt")
    featurizers, txt_dims, gru_spec, gru_vocab, w2v_dir = build_featurizers(
        config, rootpath, collection, capfile, device="cpu")  # only its vocabularies are kept
    spec = build_spec(config, vis_feature_dims(rootpath, collection, config),
                      txt_dims, gru_spec, frame_feature_dims(rootpath, collection, config))
    we = gru_init_we(config, gru_vocab, w2v_dir, np.random.default_rng(seed))
    model = seeded_model(spec, seed, we)
    opt = {"config_name": config_name, "parm_adjust_config": parm_adjust_config,
           "trainCollection": collection, "random_seed": seed}
    return checkpoint_payload(model.state_dict(), spec, config, featurizers, opt)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Options:
    """Training options: the fields of ``laff_tpu.engine.prepare.Options``
    (the reference ``do_trainer`` surface) with its defaults, plus the
    port's ``device`` and ``rank_path``, and ``sync_debug``, a check mode
    that runs the train steps between two log points under
    ``torch.cuda.set_sync_debug_mode("error")``.

    The dispatch options, as in ``laff_tpu``: ``device_feature_cache`` and
    ``device_text_cache`` keep the train features on the card (-1 auto:
    when the estimate fits ``LAFF_TPU_CACHE_BUDGET``, 0 off, 1 on);
    ``steps_per_dispatch`` runs K steps per dispatch, on the card one CUDA
    graph replayed K times (-1 auto: 8 when both caches are on, else 1);
    ``device_text_featurize`` ships bow and w2v as row ids; and
    ``stage_val_features`` keeps the validation batches on the card after
    the first pass (``LAFF_TPU_EVAL_STAGE_BUDGET``)."""

    trainCollection: str = "msrvtt10ktrain"
    valCollection: str = "msrvtt10kval"
    rootpath: str = ROOT_PATH
    trainCollection2: str = "None"
    task2_caption: str = "no_task2_caption"
    task3_caption: str = "no_task3_caption"
    train_strategy: str = "usual"
    overwrite: int = 0
    val_set: str = "setA"
    metric: str = "mir"
    num_epochs: int = 80
    batch_size: int = 128
    workers: int = 2
    model_prefix: str = "runs_0"
    config_name: str = "laff"
    parm_adjust_config: str = "None"
    device: str = "cuda"
    random_seed: int = 2
    local_rank: int = 0
    pretrained_file_path: str = "None"
    save_mean_last: int = 0
    resume: int = 0
    early_stop_patience: int = 10
    rank_path: str = "auto"
    sync_debug: int = 0
    steps_per_dispatch: int = -1
    device_feature_cache: int = -1
    device_text_cache: int = -1
    device_text_featurize: int = 0
    stage_val_features: int = 1
    # opt in to the task2 concept loss; task2_caption alone is inert
    task2_intended: int = 0
    # over one visible device a warning, then the single-device path; over
    # several it raises until its ROADMAP item lands (check_data_parallel)
    data_parallel: int = 0


def visible_devices(device: str) -> int:
    """The devices a data-parallel run could spread over: the visible
    cards for a CUDA device, one for the CPU."""
    return torch.cuda.device_count() if torch.device(device).type == "cuda" else 1


def check_data_parallel(requested: int, device: str) -> None:
    """``--data_parallel`` as ``laff_tpu`` takes it on one device: a value
    above 0 over fewer than two devices logs its warning and runs on the
    one device; over two or more it raises, naming the ROADMAP item."""
    if requested <= 0:
        return
    visible = visible_devices(device)
    if min(requested, visible) > 1:
        raise NotImplementedError(f"data_parallel={requested} over {visible} devices is not "
                                  f"ported yet: ROADMAP Queue 1 item 5")
    logger.warning("data_parallel requested but only %d device(s)", visible)


def check_options(opt: Options) -> None:
    check_data_parallel(opt.data_parallel, opt.device)
    if opt.train_strategy not in ("usual", "subset"):
        raise ValueError(f"train_strategy {opt.train_strategy!r} is not 'usual' or 'subset'")


def check_config(config) -> None:
    """A config the LAFF training slice does not take: End2EndClip (its own
    trainer)."""
    if getattr(config, "model_name", "") == "End2EndClip":
        raise ValueError("End2EndClip trains on raw frames through "
                         "laff_tpu_torch.engine.end2end.main (cli.do_trainer dispatches there), "
                         "not through trainer.prepare")


def model_dir_for(opt) -> str:
    """<root>/<train>/w2vvpp_train/<val>/<val_set>/<config>/<prefix>
    (reference ``trainer.py:88-92``)."""
    val_set = "" if opt.val_set == "no" else opt.val_set
    train = opt.trainCollection
    if opt.trainCollection2 != "None":
        train = train + "_" + opt.trainCollection2
    return os.path.join(opt.rootpath, train, "w2vvpp_train", opt.valCollection,
                        val_set, opt.config_name, opt.model_prefix)


@dataclasses.dataclass
class Prepared:
    config: object
    spec: LAFFSpec
    model_path: str
    train_feed: PairFeed
    val_txt_source: TextSource
    val_txt_batcher: TextBatcher
    val_vis_batcher: VisBatcher
    val_vis_ids: List[str]
    featurizers: Dict
    we: Optional[np.ndarray]  # w2v rows for the GRU embedding, or None
    train2_feed: Optional[PairFeed] = None  # trainCollection2's pairs, single steps
    # (K+1, D) w2v table that the step mean-pools from, with device_text_featurize
    w2v_table: Optional[np.ndarray] = None
    # task3: <val>/TextData/<val_set>/<val>.caption.negationset.txt, the
    # validation captions re-evaluated after each validation as 'task3_*'
    # metrics (reference trainer.py:120-122, 596-607)
    negationset_path: Optional[str] = None
    # the GRU vocabulary and the w2v dump its embedding starts from, for a
    # seed sweep's per-seed ``gru_init_we``
    gru_vocab: Optional[object] = None
    w2v_dir: Optional[str] = None


def _vis_files(rootpath: str, collection: str, names) -> Dict[str, BigFile]:
    return {n: BigFile(os.path.join(rootpath, collection, "FeatureData", n)) for n in names}


def open_frame_files(rootpath: str, collection: str, config) -> Dict[str, BigFile]:
    """FrameLAFF's frame BigFiles, ``FeatureData/frame/<name>`` for each of
    ``config.vid_frame_feats``; none without ``frame_feat_input``."""
    if not getattr(config, "frame_feat_input", False):
        return {}
    return {n: BigFile(os.path.join(rootpath, collection, "FeatureData", "frame", n))
            for n in config.vid_frame_feats}


def vision_source(rootpath: str, collection: str, config, vis_ids=None) -> VisionSource:
    """A collection's video features, and its frame features (capped at
    ``config.max_frame``) when the config takes them."""
    if vis_ids is None:
        vis_ids = _video_set(rootpath, collection)
    return VisionSource(_vis_files(rootpath, collection, config.vid_feats), vis_ids,
                        frame_feat_files=open_frame_files(rootpath, collection, config),
                        max_frame=config.max_frame)


def _pair_feed(config, featurizers, tsource, vsource, batch_size, seed, dtf, dtf_w2v,
               cap_ids=None, task3_source=None, task2_labels=None) -> PairFeed:
    return PairFeed(
        TextBatcher(tsource, dict(featurizers), max_txtlength=config.max_txtlength,
                    indexed_bow=dtf, indexed_w2v=dtf_w2v),
        VisBatcher(vsource, task2_labels=task2_labels), batch_size=batch_size, seed=seed,
        cap_ids=cap_ids, task3_source=task3_source)


def prepare_task2(opt: Options, config, txt_dims: Dict[str, int], vis_dims: Dict[str, int]
                  ) -> Tuple[Optional[Task2Spec], Optional[Dict[str, np.ndarray]]]:
    """The task2 (concept space) spec and per-video multi-hot labels
    (``laff_tpu.engine.prepare._prepare_task2``). Without
    ``--task2_intended 1`` a ``task2_caption`` is accepted but inert, as in
    the reference, whose task2 loss is dead code (``model/model.py:884``).
    With it: a bow vocabulary over the train collection's object-caption
    file ``<train>.caption.<task2_caption>.txt`` (saved as
    ``TextData/vocab_<suffix>/<enc>_<threshold>.pkl``), one label row per
    video id of that file, and the text head's input, the main tower's
    ``txt_feature_task2`` feature ('bow', 'w2v' or 'no')."""
    suffix = opt.task2_caption
    if suffix == "no_task2_caption":
        return None, None
    if not opt.task2_intended:
        logger.warning(
            "task2_caption=%s accepted but INERT: the reference's task2 loss is dead code "
            "(model/model.py:884 passes zeros) and parity is kept by default. Pass "
            "--task2_intended 1 for the intent implementation (concept-space auxiliary "
            "loss).", suffix)
        return None, None
    capfile = os.path.join(opt.rootpath, opt.trainCollection, "TextData",
                           f"{opt.trainCollection}.caption.{suffix}.txt")
    encoding = config.text_encoding_task2
    vocab2 = _ensure_vocab(opt.rootpath, opt.trainCollection, encoding,
                           config.threshold_task2, capfile, dirname=f"vocab_{suffix}")
    bow2 = get_txt2vec(encoding)(vocab2, norm=0)
    labels = {vis_id: (np.asarray(bow2.encoding(cap)) > 0).astype(np.float32)
              for vis_id, cap in TextSource(capfile).captions.items()}
    if not labels:
        raise ValueError(f"task2 caption file {capfile} yielded no labels")
    feat2 = config.txt_feature_task2
    if feat2 in ("bow", "w2v"):
        if feat2 not in txt_dims:
            raise ValueError(f"txt_feature_task2={feat2!r} but the main text encoding has "
                             f"no {feat2!r} feature (active: {sorted(txt_dims)})")
        txt_dim_in = txt_dims[feat2]
    elif feat2 == "no":
        txt_dim_in = 0
    else:
        raise NotImplementedError(f"txt_feature_task2={feat2!r}: only bow/w2v/no are "
                                  "supported (the gru variant would need the in-graph GRU "
                                  "encoding)")
    if not vis_dims:
        raise ValueError("task2 needs video-level features (vid_feats)")
    spec2 = Task2Spec(
        n_concepts=bow2.ndims, vis_dim_in=int(sum(vis_dims.values())), txt_feature=feat2,
        txt_dim_in=txt_dim_in, activation=config.activation_task2,
        batch_norm=config.batch_norm_task2, dropout=config.dropout_task2,
        measure=config.measure_task2, alpha=config.alpha)
    logger.info("task2 (intent) enabled: %d concepts over %d labeled videos, alpha=%.3f",
                bow2.ndims, len(labels), config.alpha)
    return spec2, labels


def _captions_file(rootpath: str, collection: str, val_set: str = "") -> str:
    return os.path.join(rootpath, collection, "TextData", val_set,
                        f"{collection}.caption.txt")


def _video_set(rootpath: str, collection: str) -> List[str]:
    return read_video_set(os.path.join(rootpath, collection, "VideoSets",
                                       f"{collection}.txt"))


def prepare(opt: Options) -> Prepared:
    """Options -> config, spec, featurizers (from the train captions), the
    GRU embedding's w2v rows, the train feeds and the validation feeds
    (``laff_tpu.engine.prepare.prepare``).

    * ``train_strategy='subset'``: no validation collection; the train
      captions split 98.5/1.5 in file order and the holdout validates.
    * ``trainCollection2``: a second train feed (seed + 1), run after each
      epoch's main one; the vocabularies live under ``<train>_<train2>``.
    * ``device_text_featurize``: bow as sparse pairs, and w2v as row ids of
      a table over the train captions' words (``w2v_table``)."""
    check_options(opt)
    opt.rootpath = os.path.expanduser(opt.rootpath)
    rootpath = opt.rootpath
    val_set = "" if opt.val_set == "no" else opt.val_set
    config = load_config(opt.config_name, opt.parm_adjust_config)
    check_config(config)
    model_path = model_dir_for(opt)
    makedirs(model_path)
    train, val, train2 = opt.trainCollection, opt.valCollection, opt.trainCollection2
    subset = opt.train_strategy == "subset"
    train_capfile = _captions_file(rootpath, train)

    # feature dims into the config, as the reference does (trainer.py:126-157)
    train_vsource = vision_source(rootpath, train, config)
    config.vis_fc_layers = [{n: f.ndims for n, f in train_vsource.feat_files.items()},
                            int(config.vis_fc_layers[1])]
    vis_dims = dict(config.vis_fc_layers[0])
    if config.vis_feat_add_concat:
        config.vis_fc_layers[0]["vis_feat_add_concat"] = int(sum(vis_dims.values()))
    frame_dims = {n: f.ndims for n, f in train_vsource.frame_feat_files.items()}
    config.vis_fc_layers[0].update(frame_dims)
    vocab_collection = train if train2 == "None" else f"{train}_{train2}"
    featurizers, txt_dims, gru_spec, gru_vocab, w2v_dir = build_featurizers(
        config, rootpath, vocab_collection, train_capfile, device=opt.device)
    if isinstance(config.txt_fc_layers, str):
        config.txt_fc_layers = [0, int(config.txt_fc_layers.split("-")[1])]
    config.txt_fc_layers[0] = int(sum(txt_dims.values()))
    task3 = opt.task3_caption != "no_task3_caption"
    task2_spec, task2_labels = prepare_task2(opt, config, txt_dims, vis_dims)
    spec = build_spec(config, vis_dims, txt_dims, gru_spec, frame_dims, task3=task3,
                      task2=task2_spec)
    # the legacy RandomState seeded like laff_tpu's np.random.seed(random_seed)
    we = gru_init_we(config, gru_vocab, w2v_dir, np.random.RandomState(opt.random_seed))

    train_tsource = TextSource(train_capfile,
                               precomputed=text_precomputed(config, train_capfile))
    train2_tsource = None
    if train2 != "None":
        capfile2 = _captions_file(rootpath, train2)
        train2_tsource = TextSource(capfile2, precomputed=text_precomputed(config, capfile2))
    task3_source = None
    if task3:
        task3_source = TextSource(
            os.path.join(rootpath, train, "TextData", f"{train}.caption.{opt.task3_caption}.txt"),
            task3=True, shuffle_seed=opt.random_seed)
        if "clip" in featurizers or "bert" in featurizers:
            logger.warning("task3 with precomputed clip/bert text features: false captions "
                           "reuse the true caption's precomputed vector (live tower pending)")

    # the w2v table must cover every caption a train feed can emit: train,
    # train2, task3's false captions and their negation-augmented variants
    dtf = bool(opt.device_text_featurize)
    w2v_table = None
    dtf_w2v = dtf and featurizers.get("w2v") is not None
    if dtf_w2v:
        caps = list(train_tsource.captions.values())
        if task3_source is not None:
            caps += [c for lst in task3_source.captions_multi.values() for c in lst]
            caps += [c for lst in task3_source.negation_augmented().values() for c in lst]
        if train2_tsource is not None:
            caps += list(train2_tsource.captions.values())
        w2v_table = featurizers["w2v"].build_row_index(caps)

    train_caps = None
    if subset:  # sequential 98.5/1.5 split (reference trainer.py:477)
        all_caps = list(train_tsource.cap_ids)
        cut = int(0.985 * len(all_caps))
        train_caps, holdout = all_caps[:cut], all_caps[cut:]
    train_feed = _pair_feed(config, featurizers, train_tsource, train_vsource, opt.batch_size,
                            opt.random_seed, dtf, dtf_w2v, cap_ids=train_caps,
                            task3_source=task3_source, task2_labels=task2_labels)
    train2_feed = None
    if train2_tsource is not None:
        train2_vsource = vision_source(rootpath, train2, config)
        train2_feed = _pair_feed(config, featurizers, train2_tsource, train2_vsource,
                                 opt.batch_size, opt.random_seed + 1, dtf, dtf_w2v)

    if subset:
        val_tsource = copy.copy(train_tsource)
        val_tsource.cap_ids = holdout
        val_ids = list(dict.fromkeys(c.split("#")[0] for c in holdout))
        val_vsource = train_vsource
    else:
        val_capfile = _captions_file(rootpath, val, val_set)
        val_tsource = TextSource(val_capfile, precomputed=text_precomputed(config, val_capfile))
        val_ids = _video_set(rootpath, val)
        val_vsource = vision_source(rootpath, val, config, val_ids)
    return Prepared(
        config=config, spec=spec, model_path=model_path, train_feed=train_feed,
        val_txt_source=val_tsource,
        val_txt_batcher=TextBatcher(val_tsource, dict(featurizers),
                                    max_txtlength=config.max_txtlength, indexed_bow=dtf),
        val_vis_batcher=VisBatcher(val_vsource), val_vis_ids=val_ids,
        featurizers=featurizers, we=we, train2_feed=train2_feed, w2v_table=w2v_table,
        negationset_path=(os.path.join(rootpath, val, "TextData", val_set,
                                       f"{val}.caption.negationset.txt") if task3 else None),
        gru_vocab=gru_vocab, w2v_dir=w2v_dir)
