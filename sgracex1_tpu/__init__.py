"""SGRACEx1: a JAX framework for sparse GNN inference and training.

A from-scratch JAX/XLA re-design of the capabilities of the SGRACE
FPGA dataflow accelerator (reference: hadimsnj/SGRACEx1):

- CSR/COO sparse graph containers and loaders (reference 3-line CSR text format)
- SpMM aggregation ``D = ReLU?(A @ (X @ W))`` with sparse or dense features
  (reference ``gemm_mode`` 0/1/2 — ``src/kernelMatrixmult_all.cpp:3762``)
- GAT attention: SDDMM edge scores + edge-masked softmax
  (reference ``demo/sgrace_lib/sgrace.py:309-314,634-657``)
- Adaptive quantization 1/2/4/8-bit with fake-quant QAT and int8 inference
  (reference ``sgrace.py:53-265,1296-1845``)
- Full forward/backward training through the kernels via ``jax.custom_vjp``
  (reference autograd functions ``FPYNQ_GAT``/``RPYNQ`` — ``sgrace.py:267-1126``)
- Multi-chip/multi-host scaling via ``jax.sharding`` meshes + ``shard_map``
  (the replacement for the reference's FEA/ADJ thread row-sharding)

Unlike the reference (an HLS dataflow engine + PYNQ host runtime), everything
here is built for an accelerator driven by XLA: static shapes, the edge path
(gather + segment sum) for the hot sparse ops, dense matmuls where the graph
is small and dense, and XLA collectives for scaling.
"""

__version__ = "0.1.0"

from sgracex1_tpu.config import SGRACEConfig
from sgracex1_tpu.graph.csr import SparseMatrix
from sgracex1_tpu.graph.normalize import sym_norm
from sgracex1_tpu.ops.spmm import spmm, spmm_t
from sgracex1_tpu.ops.fused_gnn import gnn_layer

__all__ = [
    "SGRACEConfig",
    "SparseMatrix",
    "sym_norm",
    "spmm",
    "spmm_t",
    "gnn_layer",
]
