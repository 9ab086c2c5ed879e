"""Config -> text featurizers, model spec, feeds, and a seeded model.

The parts of ``laff_tpu.engine.prepare`` that prediction and training
need: ``load_config``, ``build_featurizers`` (BoW / w2v / GRU ids /
precomputed CLIP, in the reference's encoder order), ``build_spec``, the
trainer's ``Options`` and ``prepare`` (``train_strategy`` 'usual' or
'subset', an optional ``trainCollection2``, the indexed text feed of
``device_text_featurize``), and ``init_checkpoint``, which seeds a model for
a collection as the trainer does before its first step. Vocabularies are
built from the train captions when their pickle is missing, and saved in
the reference layout.

FrameLAFF configs (``frame_feat_input``) open their frame BigFiles from
``FeatureData/frame/<name>`` of each collection (train, validation,
``trainCollection2``) and feed them padded to ``max_frame``.

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
from ..models.laff import LAFFModel
from ..models.registry import END2END_NOT_PORTED
from ..models.spec import AttentionSpec, GruSpec, LAFFSpec, TowerSpec, TransformSpec
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


def _ensure_vocab(rootpath, collection, encoding, threshold, capfile):
    path = os.path.join(rootpath, collection, "TextData", "vocab",
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


def build_featurizers(config, rootpath: str, vocab_collection: str, train_capfile: str):
    """Text featurizer bank for the feed and the text-tower feature dims,
    in the reference's encoder order (rnn, bert, bow, w2v, clip, netvlad).
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
               frame_dims: Optional[Dict[str, int]] = None) -> LAFFSpec:
    """config + discovered feature dims (``frame_dims``: FrameLAFF's frame
    features) -> frozen LAFFSpec (``laff_tpu.engine.prepare.build_spec``
    without task2, task3 and a live BERT). The NetVLAD cluster count is the
    config's (``NetVLAD_opt``), whose product with the w2v width is the
    'netvlad' feature's."""
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
    txt = TowerSpec(
        features=tuple(txt_dims.items()), common_dim=txt_common,
        attention=_attn_spec(config, config.txt_attention), no_transform=txt_nt,
        transform_overrides=tuple(overrides),
        expert_embedding=config.txt_expert_embedding["expert"],
        expert_l2norm=config.txt_expert_embedding["l2norm"],
        dropout=config.dropout, batch_norm=config.batch_norm,
        activation=config.activation, gru=gru_spec, compute_dtype=compute_dtype,
        netvlad_clusters=int(config.NetVLAD_opt["num_clusters"]),
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
        loss=config.loss,
    )


def vis_feature_dims(rootpath: str, collection: str, config) -> Dict[str, int]:
    return {n: f.ndims for n, f in _vis_files(rootpath, collection, config.vid_feats).items()}


def frame_feature_dims(rootpath: str, collection: str, config) -> Dict[str, int]:
    return {n: f.ndims for n, f in open_frame_files(rootpath, collection, config).items()}


def seeded_model(spec: LAFFSpec, seed: int, we: Optional[np.ndarray] = None) -> LAFFModel:
    """A model with the JAX package's init distributions from ``seed``
    (xavier transforms, torch-default gates and GRU, BatchNorm at its
    identity running stats), with ``we`` in the GRU embedding if given."""
    model = LAFFModel(spec)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    if we is not None:
        with torch.no_grad():
            model.txt_net.gru.we.weight.copy_(torch.from_numpy(we))
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
        config, rootpath, collection, capfile)
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
    # options of laff_tpu that raise here until their ROADMAP item lands
    data_parallel: int = 0
    task2_intended: int = 0


# option, the values the port runs, the ROADMAP item that brings the others
_NOT_PORTED = (
    ("data_parallel", lambda v: v in (0, 1), "data_parallel (ROADMAP Queue 1 item 5)"),
    ("task3_caption", lambda v: v == "no_task3_caption", "task3 (ROADMAP Queue 1 item 1)"),
    ("task2_intended", lambda v: v == 0, "task2 (ROADMAP Queue 1 item 1)"),
)


def check_options(opt: Options) -> None:
    for name, ported, later in _NOT_PORTED:
        value = getattr(opt, name)
        if not ported(value):
            raise NotImplementedError(f"{name}={value!r} is not ported yet: {later}")
    if opt.train_strategy not in ("usual", "subset"):
        raise ValueError(f"train_strategy {opt.train_strategy!r} is not 'usual' or 'subset'")
    if opt.task2_caption != "no_task2_caption":
        logger.warning("task2_caption=%s accepted but inert, as in laff_tpu without "
                       "--task2_intended 1", opt.task2_caption)


def check_config(config) -> None:
    """Config features the training slice does not have yet."""
    if getattr(config, "model_name", "") == "End2EndClip":
        raise NotImplementedError(END2END_NOT_PORTED)
    if "no" not in config.text_encoding["bert_encoding"]["name"]:
        raise NotImplementedError("a BERT text tower is not ported yet: ROADMAP Queue 1 item 4")


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
               cap_ids=None) -> PairFeed:
    return PairFeed(
        TextBatcher(tsource, dict(featurizers), max_txtlength=config.max_txtlength,
                    indexed_bow=dtf, indexed_w2v=dtf_w2v),
        VisBatcher(vsource), batch_size=batch_size, seed=seed, cap_ids=cap_ids)


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
        config, rootpath, vocab_collection, train_capfile)
    if isinstance(config.txt_fc_layers, str):
        config.txt_fc_layers = [0, int(config.txt_fc_layers.split("-")[1])]
    config.txt_fc_layers[0] = int(sum(txt_dims.values()))
    spec = build_spec(config, vis_dims, txt_dims, gru_spec, frame_dims)
    # the legacy RandomState seeded like laff_tpu's np.random.seed(random_seed)
    we = gru_init_we(config, gru_vocab, w2v_dir, np.random.RandomState(opt.random_seed))

    train_tsource = TextSource(train_capfile,
                               precomputed=text_precomputed(config, train_capfile))
    train2_tsource = None
    if train2 != "None":
        capfile2 = _captions_file(rootpath, train2)
        train2_tsource = TextSource(capfile2, precomputed=text_precomputed(config, capfile2))

    # the w2v table must cover every caption a train feed can emit
    dtf = bool(opt.device_text_featurize)
    w2v_table = None
    dtf_w2v = dtf and featurizers.get("w2v") is not None
    if dtf_w2v:
        caps = list(train_tsource.captions.values())
        if train2_tsource is not None:
            caps += list(train2_tsource.captions.values())
        w2v_table = featurizers["w2v"].build_row_index(caps)

    train_caps = None
    if subset:  # sequential 98.5/1.5 split (reference trainer.py:477)
        all_caps = list(train_tsource.cap_ids)
        cut = int(0.985 * len(all_caps))
        train_caps, holdout = all_caps[:cut], all_caps[cut:]
    train_feed = _pair_feed(config, featurizers, train_tsource, train_vsource, opt.batch_size,
                            opt.random_seed, dtf, dtf_w2v, cap_ids=train_caps)
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
        featurizers=featurizers, we=we, train2_feed=train2_feed, w2v_table=w2v_table)
