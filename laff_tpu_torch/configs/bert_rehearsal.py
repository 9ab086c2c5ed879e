# The rehearsal model (configs/rehearsal.py: LAFF-ml at full width, 8 heads
# of 512 over the four video features, bf16 towers) with its precomputed
# CLIP text rows replaced by an in-graph BERT-base tower (reference
# BertTxtEncoder with bert_frozen=False, model/model.py:437-466): bow, w2v,
# GRU-mean and BERT's pooler output, so every text feature is computed
# from the caption and the model serves ad-hoc queries. BERT-base at
# transformers' BertConfig defaults (12 layers, 768 wide, 12 heads, 3,072
# intermediate, a vocabulary of 30,522, 512 positions: 109,482,240
# parameters, 438 MB of f32), captions cut to 64 tokens, trained at lr/20
# in f32 (FlaxBertModule computes in f32 beside the bf16 towers).
#
# The tower starts from a local bert-base-uncased checkout (config.json,
# vocab.txt, model.safetensors or pytorch_model.bin) named by
# LAFF_TPU_BERT_CHECKOUT, read at instantiation; without it the encoder name
# stays 'bert-base-uncased', which is not downloaded: the vocabulary must
# then come from bert_vocab_file and the weights start from the seed.
import os

from . import rehearsal


class config(rehearsal.config):
    text_encoding = {
        'bow_encoding': {'name': 'bow_nsw'},
        'w2v_encoding': {'name': 'w2v_nsw'},
        'rnn_encoding': {'name': 'gru_mean'},
        'bert_encoding': {'name': 'bert-base-uncased'},
        'CLIP_encoding': {'name': 'noCLIP'},
        'NetVLAD_encoding': {'name': 'noNetVLAD'},
    }
    txt_no_transform = []
    bert_frozen = False
    bert_max_length = 64
    bert_config_kwargs = {}
    bert_vocab_file = ''

    def __init__(self):
        checkout = os.environ.get("LAFF_TPU_BERT_CHECKOUT", "")
        if checkout:
            self.text_encoding = {k: dict(v) for k, v in self.text_encoding.items()}
            self.text_encoding['bert_encoding']['name'] = checkout

    def adjust_parm(self, value):
        """rehearsal's sweep string; its one text encoding set is this
        config's (the BERT tower in CLIP's place)."""
        bert = self.text_encoding['bert_encoding']['name']
        super().adjust_parm(value)
        self.text_encoding['bert_encoding']['name'] = bert
        self.text_encoding['CLIP_encoding']['name'] = 'noCLIP'
