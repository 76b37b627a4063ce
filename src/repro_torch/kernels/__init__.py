"""Hand-written CUDA kernels of the port, each with a plain PyTorch version
beside it: blocked-ELL delivery and fused delivery -> LIF
(:mod:`.spike_prop`), the LIF step (:mod:`.lif`), flash attention
(:mod:`.flash_attention`) and JAX's threefry draws (:mod:`.threefry`);
:mod:`.build` compiles and loads them."""
