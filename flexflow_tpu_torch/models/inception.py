"""Inception-v3 model builder.

The PyTorch counterpart of flexflow_tpu/models/inception.py, the same
network as reference examples/cpp/InceptionV3/inception.cc: the
InceptionA-E modules built from conv + BatchNorm + pool + concat.
"""
from __future__ import annotations

from ..core.model import FFModel
from ..ff_types import DataType, PoolType


def conv_bn(model, t, filters, kh, kw, sh=1, sw=1, ph=0, pw=0):
    t = model.conv2d(t, filters, kh, kw, sh, sw, ph, pw)
    return model.batch_norm(t, relu=True)


def inception_a(model, t, pool_features):
    """reference: inception.cc InceptionA"""
    b1 = conv_bn(model, t, 64, 1, 1)
    b2 = conv_bn(model, t, 48, 1, 1)
    b2 = conv_bn(model, b2, 64, 5, 5, 1, 1, 2, 2)
    b3 = conv_bn(model, t, 64, 1, 1)
    b3 = conv_bn(model, b3, 96, 3, 3, 1, 1, 1, 1)
    b3 = conv_bn(model, b3, 96, 3, 3, 1, 1, 1, 1)
    b4 = model.pool2d(t, 3, 3, 1, 1, 1, 1, PoolType.POOL_AVG)
    b4 = conv_bn(model, b4, pool_features, 1, 1)
    return model.concat([b1, b2, b3, b4], axis=1)


def inception_b(model, t):
    b1 = conv_bn(model, t, 384, 3, 3, 2, 2)
    b2 = conv_bn(model, t, 64, 1, 1)
    b2 = conv_bn(model, b2, 96, 3, 3, 1, 1, 1, 1)
    b2 = conv_bn(model, b2, 96, 3, 3, 2, 2)
    b3 = model.pool2d(t, 3, 3, 2, 2, 0, 0)
    return model.concat([b1, b2, b3], axis=1)


def inception_c(model, t, channels_7x7):
    c = channels_7x7
    b1 = conv_bn(model, t, 192, 1, 1)
    b2 = conv_bn(model, t, c, 1, 1)
    b2 = conv_bn(model, b2, c, 1, 7, 1, 1, 0, 3)
    b2 = conv_bn(model, b2, 192, 7, 1, 1, 1, 3, 0)
    b3 = conv_bn(model, t, c, 1, 1)
    b3 = conv_bn(model, b3, c, 7, 1, 1, 1, 3, 0)
    b3 = conv_bn(model, b3, c, 1, 7, 1, 1, 0, 3)
    b3 = conv_bn(model, b3, c, 7, 1, 1, 1, 3, 0)
    b3 = conv_bn(model, b3, 192, 1, 7, 1, 1, 0, 3)
    b4 = model.pool2d(t, 3, 3, 1, 1, 1, 1, PoolType.POOL_AVG)
    b4 = conv_bn(model, b4, 192, 1, 1)
    return model.concat([b1, b2, b3, b4], axis=1)


def inception_d(model, t):
    b1 = conv_bn(model, t, 192, 1, 1)
    b1 = conv_bn(model, b1, 320, 3, 3, 2, 2)
    b2 = conv_bn(model, t, 192, 1, 1)
    b2 = conv_bn(model, b2, 192, 1, 7, 1, 1, 0, 3)
    b2 = conv_bn(model, b2, 192, 7, 1, 1, 1, 3, 0)
    b2 = conv_bn(model, b2, 192, 3, 3, 2, 2)
    b3 = model.pool2d(t, 3, 3, 2, 2, 0, 0)
    return model.concat([b1, b2, b3], axis=1)


def inception_e(model, t):
    b1 = conv_bn(model, t, 320, 1, 1)
    b2 = conv_bn(model, t, 384, 1, 1)
    b2a = conv_bn(model, b2, 384, 1, 3, 1, 1, 0, 1)
    b2b = conv_bn(model, b2, 384, 3, 1, 1, 1, 1, 0)
    b2 = model.concat([b2a, b2b], axis=1)
    b3 = conv_bn(model, t, 448, 1, 1)
    b3 = conv_bn(model, b3, 384, 3, 3, 1, 1, 1, 1)
    b3a = conv_bn(model, b3, 384, 1, 3, 1, 1, 0, 1)
    b3b = conv_bn(model, b3, 384, 3, 1, 1, 1, 1, 0)
    b3 = model.concat([b3a, b3b], axis=1)
    b4 = model.pool2d(t, 3, 3, 1, 1, 1, 1, PoolType.POOL_AVG)
    b4 = conv_bn(model, b4, 192, 1, 1)
    return model.concat([b1, b2, b3, b4], axis=1)


def build_inception_v3(model: FFModel, batch_size: int,
                       num_classes: int = 1000, height: int = 299,
                       width: int = 299):
    """reference: inception.cc top_level_task. Returns (input, output)."""
    input_t = model.create_tensor((batch_size, 3, height, width),
                                  DataType.DT_FLOAT)
    t = conv_bn(model, input_t, 32, 3, 3, 2, 2)
    t = conv_bn(model, t, 32, 3, 3)
    t = conv_bn(model, t, 64, 3, 3, 1, 1, 1, 1)
    t = model.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = conv_bn(model, t, 80, 1, 1)
    t = conv_bn(model, t, 192, 3, 3)
    t = model.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = inception_a(model, t, 32)
    t = inception_a(model, t, 64)
    t = inception_a(model, t, 64)
    t = inception_b(model, t)
    t = inception_c(model, t, 128)
    t = inception_c(model, t, 160)
    t = inception_c(model, t, 160)
    t = inception_c(model, t, 192)
    t = inception_d(model, t)
    t = inception_e(model, t)
    t = inception_e(model, t)
    t = model.pool2d(t, t.dims[2], t.dims[3], 1, 1, 0, 0, PoolType.POOL_AVG)
    t = model.flat(t)
    t = model.dense(t, num_classes)
    t = model.softmax(t)
    return input_t, t
