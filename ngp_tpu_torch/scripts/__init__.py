"""The port's entry points beside ``run.py``, each run as ``python -m
ngp_tpu_torch.scripts.<name>``: the dataset and image converters
``colmap2nerf``, ``nsvf2nerf``, ``record3d2nerf`` and ``convert_image``;
the web viewer ``viewer``; the Block-NeRF street CLI ``blocknerf``."""
