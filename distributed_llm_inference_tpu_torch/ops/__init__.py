"""Tensor ops of the port: plain PyTorch functions, plus the CUDA kernels
(``paged_attention``, ``ragged_attention``, each over bf16/f32 or int8
pages, and ``quant_matmul``'s int4 matmul) with their plain versions. Import the submodules directly; nothing is re-exported here,
so a submodule and its main function never shadow each other."""
