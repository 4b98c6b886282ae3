"""Models of the port: LeNet, ResNet, BERT, DeepFM, Transformer, and the
book's seq2seq (GRU, beam search), word2vec and VGG16-BN."""

from . import (bert, deepfm, lenet, resnet, seq2seq,  # noqa: F401
               transformer, vgg, word2vec)
