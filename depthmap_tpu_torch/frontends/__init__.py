"""User-facing surfaces of the port: the REST API, the Gradio UI and the
WebUI script (the CLI is ``depthmap_tpu_torch/cli.py``), each the JAX
package's ``frontends/`` module of the same name on the port's funnel."""
