"""Ops of the port: RoPE, paged KV pools and the kernel wrappers."""
