"""The port's measuring tools, one module per tool of the JAX package's
`tools/` that measures the system; each runs as
`python -m pobrax_tpu_torch.tools.<name>` on the card unless a device is
named, and writes its records under `runs/`, never `docs/`."""
