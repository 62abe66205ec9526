"""Command line (``python -m fairness_llm_tpu_torch.cli.main``)."""
