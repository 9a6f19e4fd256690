"""Tensor ops of the port: plain PyTorch functions, plus the two CUDA
attention kernels (``paged_attention``, ``ragged_attention``) with their
plain versions. Import the submodules directly; nothing is re-exported here,
so a submodule and its main function never shadow each other."""
