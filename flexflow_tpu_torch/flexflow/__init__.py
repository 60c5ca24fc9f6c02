"""The `flexflow` drop-in namespace of the port: the counterpart of the
repo's flexflow/ shim, mapping the reference's Python package surface
(python/flexflow/: flexflow.core, flexflow.keras, flexflow.torch,
flexflow.onnx, flexflow.keras_exp) onto flexflow_tpu_torch, module for
module.

A script written for the reference imports `flexflow`, not this
package: `python -m flexflow_tpu_torch.run script.py` runs it with
`flexflow` resolved here (run.py's import aliases).
"""
from flexflow_tpu_torch import __version__  # noqa: F401
