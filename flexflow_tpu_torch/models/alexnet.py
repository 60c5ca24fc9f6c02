"""AlexNet: the FFModel builder, and the bootcamp's torch.nn.Module.

The PyTorch counterpart of flexflow_tpu/models/alexnet.py (reference:
examples/cpp/AlexNet/alexnet.cc:70-83 and bootcamp_demo/
ff_alexnet_cifar10.py, the CIFAR-10 throughput configuration of
BASELINE.md: 3x229x229 inputs, batch 64, 10 classes). `build_alexnet`
builds it through the FFModel API with the convolutions' RELU fused.
`AlexNet` is the same stack as a plain torch.nn.Module (the one
bootcamp_demo/torch_alexnet_cifar10.py defines, kept here because that
script imports the JAX package's exporter): RELU as separate modules,
`x.flatten(1)` before the classifier. It enters an FFModel through the
PyTorch frontend, live (`PyTorchModel(AlexNet()).torch_to_ff`) or from
its `.ff` export (`torch_to_flexflow(AlexNet(), path)`, then
`PyTorchModel(path).apply`).
"""
from __future__ import annotations

from torch import nn

from ..core.model import FFModel
from ..ff_types import ActiMode, DataType


def build_alexnet(model: FFModel, batch_size: int, num_classes: int = 10,
                  height: int = 229, width: int = 229):
    """reference topology: alexnet.cc:70-83 (conv 64k11s4p2 ... dense
    4096). Returns (input tensor, output tensor)."""
    input_t = model.create_tensor((batch_size, 3, height, width),
                                  DataType.DT_FLOAT, name="image")
    relu = ActiMode.AC_MODE_RELU
    t = model.conv2d(input_t, 64, 11, 11, 4, 4, 2, 2, relu)
    t = model.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = model.conv2d(t, 192, 5, 5, 1, 1, 2, 2, relu)
    t = model.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = model.conv2d(t, 384, 3, 3, 1, 1, 1, 1, relu)
    t = model.conv2d(t, 256, 3, 3, 1, 1, 1, 1, relu)
    t = model.conv2d(t, 256, 3, 3, 1, 1, 1, 1, relu)
    t = model.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = model.flat(t)
    t = model.dense(t, 4096, relu)
    t = model.dense(t, 4096, relu)
    t = model.dense(t, num_classes)
    t = model.softmax(t)
    return input_t, t


class AlexNet(nn.Module):
    """torchvision-style AlexNet, the bootcamp's: 256x6x6 features at a
    229x229 input."""

    def __init__(self, num_classes: int = 10):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2d(3, 64, kernel_size=11, stride=4, padding=2),
            nn.ReLU(inplace=True),
            nn.MaxPool2d(kernel_size=3, stride=2),
            nn.Conv2d(64, 192, kernel_size=5, padding=2),
            nn.ReLU(inplace=True),
            nn.MaxPool2d(kernel_size=3, stride=2),
            nn.Conv2d(192, 384, kernel_size=3, padding=1),
            nn.ReLU(inplace=True),
            nn.Conv2d(384, 256, kernel_size=3, padding=1),
            nn.ReLU(inplace=True),
            nn.Conv2d(256, 256, kernel_size=3, padding=1),
            nn.ReLU(inplace=True),
            nn.MaxPool2d(kernel_size=3, stride=2),
        )
        self.classifier = nn.Sequential(
            nn.Linear(256 * 6 * 6, 4096),
            nn.ReLU(inplace=True),
            nn.Linear(4096, 4096),
            nn.ReLU(inplace=True),
            nn.Linear(4096, num_classes),
            nn.Softmax(dim=-1),
        )

    def forward(self, x):
        x = self.features(x)
        x = x.flatten(1)
        return self.classifier(x)
