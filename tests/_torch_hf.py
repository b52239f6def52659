"""Tiny random Hugging Face checkpoints saved locally, for the port's default model paths (no download).

``transformers`` is imported without its TensorFlow backend (``USE_TF=0``), which nothing here uses and which
takes seconds to import.
"""

from __future__ import annotations

import json
import os
import pathlib

import pytest
import torch

CLIP_WORDS = ["a", "photo", "of", "the", "cat", "dog", "good", "bad", "."]
BERT_WORDS = "the cat sat on mat a dog ran far away quick brown fox jumps over lazy photo".split()


def transformers():
    os.environ.setdefault("USE_TF", "0")
    return pytest.importorskip("transformers")


def tiny_clip(directory: pathlib.Path, seed: int = 0):
    """A 2-layer, 32-wide random ``CLIPModel`` (32² images, patch 8, projection 16) with a hand-written BPE
    vocabulary (single characters and a few whole words, no merges) and image-processor settings, written as
    files and read back through ``AutoProcessor``. Returns ``(path, model, processor)``."""
    tf = transformers()
    directory.mkdir(parents=True, exist_ok=True)
    vocab = {"<|startoftext|>": 0, "<|endoftext|>": 1}
    for w in CLIP_WORDS:
        vocab[w + "</w>"] = len(vocab)
    for c in sorted(set("".join(CLIP_WORDS)) | set("abcdefghijklmnopqrstuvwxyz")):
        vocab.setdefault(c, len(vocab))
        vocab.setdefault(c + "</w>", len(vocab))
    (directory / "vocab.json").write_text(json.dumps(vocab))
    (directory / "merges.txt").write_text("#version: 0.2\n")
    (directory / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "CLIPTokenizer", "bos_token": "<|startoftext|>", "eos_token": "<|endoftext|>",
        "unk_token": "<|endoftext|>", "pad_token": "<|endoftext|>", "model_max_length": 64}))
    (directory / "preprocessor_config.json").write_text(json.dumps({
        "image_processor_type": "CLIPImageProcessor", "do_resize": True, "size": {"shortest_edge": 32},
        "do_center_crop": True, "crop_size": {"height": 32, "width": 32}, "do_rescale": False, "do_normalize": True,
        "image_mean": [0.48145466, 0.4578275, 0.40821073], "image_std": [0.26862954, 0.26130258, 0.27577711],
        "resample": 3, "do_convert_rgb": False}))
    cfg = tf.CLIPConfig(
        text_config=dict(vocab_size=len(vocab), hidden_size=32, intermediate_size=37, num_hidden_layers=2,
                         num_attention_heads=4, max_position_embeddings=64, bos_token_id=0, eos_token_id=1,
                         pad_token_id=1),
        vision_config=dict(hidden_size=32, intermediate_size=37, num_hidden_layers=2, num_attention_heads=4,
                           image_size=32, patch_size=8),
        projection_dim=16)
    torch.manual_seed(seed)
    model = tf.CLIPModel(cfg).eval()
    model.save_pretrained(str(directory))
    return str(directory), model, tf.AutoProcessor.from_pretrained(str(directory))


def tiny_bert(directory: pathlib.Path, seed: int = 0):
    """A 2-layer, 32-wide random ``BertModel`` with a hand-written word vocabulary, saved with
    ``save_pretrained``. Returns ``(path, model, tokenizer)``."""
    tf = transformers()
    cfg = tf.BertConfig(vocab_size=40, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                        intermediate_size=37, max_position_embeddings=64)
    torch.manual_seed(seed)
    model = tf.BertModel(cfg).eval()
    model.save_pretrained(str(directory))
    (directory / "vocab.txt").write_text("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + BERT_WORDS))
    (directory / "tokenizer_config.json").write_text(json.dumps({"tokenizer_class": "BertTokenizer",
                                                                "do_lower_case": True}))
    return str(directory), model, tf.BertTokenizer(str(directory / "vocab.txt"))
