"""Data layer: Gosai DNA / RNA 5'UTR datasets, tokenizers, and
fault-tolerant iterators."""

from svdd.data import gosai  # noqa: F401
