"""ResNet / ResNeXt model builders.

The PyTorch counterpart of flexflow_tpu/models/resnet.py (reference:
examples/cpp/ResNet/resnet.cc BottleneckBlock and
examples/cpp/resnext50/resnext.cc, the grouped-conv ResNeXt-50 that
scripts/osdi22ae/resnext-50.sh trains at batch 16), through the FFModel
API. Their BatchNorm ops carry running statistics in
`model.state.net_state`.
"""
from __future__ import annotations

from ..core.model import FFModel
from ..ff_types import DataType, PoolType


def bottleneck_block(model: FFModel, t, out_channels: int, stride: int,
                     projection: bool):
    """reference: resnet.cc BottleneckBlock -- 1x1 / 3x3 / 1x1 conv with
    batch norm and a residual add."""
    shortcut = t
    t = model.conv2d(t, out_channels, 1, 1, 1, 1, 0, 0)
    t = model.batch_norm(t, relu=True)
    t = model.conv2d(t, out_channels, 3, 3, stride, stride, 1, 1)
    t = model.batch_norm(t, relu=True)
    t = model.conv2d(t, out_channels * 4, 1, 1, 1, 1, 0, 0)
    t = model.batch_norm(t, relu=False)
    if projection:
        shortcut = model.conv2d(shortcut, out_channels * 4, 1, 1, stride,
                                stride, 0, 0)
        shortcut = model.batch_norm(shortcut, relu=False)
    t = model.add(t, shortcut)
    return model.relu(t)


def build_resnet(model: FFModel, batch_size: int, num_classes: int = 10,
                 height: int = 229, width: int = 229,
                 blocks_per_stage=(3, 4, 6, 3)):
    """reference: resnet.cc top_level_task (ResNet-50's shape)."""
    input_t = model.create_tensor((batch_size, 3, height, width),
                                  DataType.DT_FLOAT)
    t = model.conv2d(input_t, 64, 7, 7, 2, 2, 3, 3)
    t = model.batch_norm(t, relu=True)
    t = model.pool2d(t, 3, 3, 2, 2, 1, 1)
    channels = 64
    for stage, n_blocks in enumerate(blocks_per_stage):
        for b in range(n_blocks):
            stride = 2 if (b == 0 and stage > 0) else 1
            t = bottleneck_block(model, t, channels, stride,
                                 projection=(b == 0))
        channels *= 2
    t = model.pool2d(t, t.dims[2], t.dims[3], 1, 1, 0, 0, PoolType.POOL_AVG)
    t = model.flat(t)
    t = model.dense(t, num_classes)
    t = model.softmax(t)
    return input_t, t


def resnext_block(model: FFModel, t, stride: int, out_channels: int,
                  groups: int = 32, projection: bool = False):
    """reference: resnext.cc resnext_block (grouped 3x3 conv)."""
    shortcut = t
    t = model.conv2d(t, out_channels, 1, 1, 1, 1, 0, 0)
    t = model.batch_norm(t, relu=True)
    t = model.conv2d(t, out_channels, 3, 3, stride, stride, 1, 1,
                     groups=groups)
    t = model.batch_norm(t, relu=True)
    t = model.conv2d(t, 2 * out_channels, 1, 1, 1, 1, 0, 0)
    t = model.batch_norm(t, relu=False)
    if projection or stride > 1:
        shortcut = model.conv2d(shortcut, 2 * out_channels, 1, 1, stride,
                                stride, 0, 0)
        shortcut = model.batch_norm(shortcut, relu=False)
    t = model.add(t, shortcut)
    return model.relu(t)


def build_resnext50(model: FFModel, batch_size: int, num_classes: int = 10,
                    height: int = 224, width: int = 224):
    """reference: resnext.cc top_level_task."""
    input_t = model.create_tensor((batch_size, 3, height, width),
                                  DataType.DT_FLOAT)
    t = model.conv2d(input_t, 64, 7, 7, 2, 2, 3, 3)
    t = model.batch_norm(t, relu=True)
    t = model.pool2d(t, 3, 3, 2, 2, 1, 1)
    for stage, (n_blocks, ch) in enumerate(
            zip((3, 4, 6, 3), (128, 256, 512, 1024))):
        for b in range(n_blocks):
            stride = 2 if (b == 0 and stage > 0) else 1
            t = resnext_block(model, t, stride, ch, projection=(b == 0))
    t = model.pool2d(t, t.dims[2], t.dims[3], 1, 1, 0, 0, PoolType.POOL_AVG)
    t = model.flat(t)
    t = model.dense(t, num_classes)
    t = model.softmax(t)
    return input_t, t
