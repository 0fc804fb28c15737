"""hhsuite_tpu_torch: the HH-suite3 search engine in PyTorch, with the
Viterbi dynamic programming as hand-written CUDA kernels for NVIDIA
Hopper (sm_90a).

Entry points run on the CUDA device unless the caller asks for the CPU
(``device="cpu"``, or ``HHSUITE_TPU_TORCH_DEVICE=cpu`` for the CLI); on
the CPU every kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
