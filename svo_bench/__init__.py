"""The benchmark of the PyTorch/CUDA port (`android_svo_tpu_torch`): one
cell of `BENCHMARK.json` per run (`python3 -m svo_bench.run`), its inputs
made from the seed, its outputs held against the plain reference in
`svo_bench/reference/`.  Nothing here imports JAX or the JAX package."""
