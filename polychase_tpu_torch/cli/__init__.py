"""Headless command-line tools of the port (``generate_database``,
``visualize_flow``), run as ``python -m polychase_tpu_torch.cli.<tool>``."""
