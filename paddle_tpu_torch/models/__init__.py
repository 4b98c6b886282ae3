"""Models of the port: LeNet, ResNet, BERT, DeepFM, Transformer, and the
book's seq2seq (GRU, beam search), word2vec, VGG16-BN and the sentiment
nets over LoD sequences."""

from . import (bert, deepfm, lenet, resnet, seq2seq,  # noqa: F401
               sentiment, transformer, vgg, word2vec)
