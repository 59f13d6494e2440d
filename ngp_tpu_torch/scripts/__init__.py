"""The port's dataset and image conversion entry points, each run as
``python -m ngp_tpu_torch.scripts.<name>``: ``colmap2nerf``,
``nsvf2nerf``, ``record3d2nerf`` and ``convert_image``."""
