"""The benchmark of the PyTorch and CUDA port (``audio_edge_ml_pipeline_torch``).

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell once; ``README.md`` says how the files fit together.
"""
