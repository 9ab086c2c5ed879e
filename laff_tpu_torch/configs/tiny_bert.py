# Tiny live-BERT config: exercises the IN-GRAPH BERT tower
# (bert_frozen=False, reference model/model.py:437-466) with a random tiny
# transformer so the path tests offline. The WordPiece vocab file is
# injected via LAFF_TPU_TEST_BERT_VOCAB (read at instantiation).
import os

from .tiny import config as TinyConfig


class config(TinyConfig):
    text_encoding = {
        'bow_encoding': {'name': 'bow_nsw'},
        'w2v_encoding': {'name': 'noW2v'},
        'rnn_encoding': {'name': 'nogru_mean'},
        'bert_encoding': {'name': 'bert-tiny-test'},
        'CLIP_encoding': {'name': 'noCLIP'},
        'NetVLAD_encoding': {'name': 'noNetVLAD'},
    }
    bert_frozen = False
    bert_size = 16
    bert_max_length = 16
    bert_config_kwargs = {
        'vocab_size': 64, 'hidden_size': 16, 'num_hidden_layers': 1,
        'num_attention_heads': 2, 'intermediate_size': 32,
        'max_position_embeddings': 32,
    }

    def __init__(self):
        self.bert_vocab_file = os.environ.get("LAFF_TPU_TEST_BERT_VOCAB", "")
