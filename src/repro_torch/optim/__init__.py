"""Optimizers of the port: AdamW and ZeRO-1 over the circulant collectives."""
