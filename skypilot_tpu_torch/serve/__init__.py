"""The serving fleet of the port (port of skypilot_tpu/serve/'s
autoscalers, load-balancing policies, service spec, replica status and
the replica plane): framework-free Python over the port's `serve_lm`
replicas. Entry point: `python -m skypilot_tpu_torch.recipes.serve_fleet`.
"""
