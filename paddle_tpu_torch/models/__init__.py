"""Models of the port: LeNet, ResNet, BERT, DeepFM, Transformer, and the
book's seq2seq (GRU, beam search), word2vec, VGG16-BN, and over LoD
sequences the sentiment nets, the CRF tagger and the recommender."""

from . import (bert, deepfm, lenet, recommender, resnet,  # noqa: F401
               sentiment, seq2seq, tagger, transformer, vgg, word2vec)
