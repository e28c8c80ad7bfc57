"""Serving: the KV pool (block ledger, prefix cache, session park and
resume) and the server-side ``DecodeEngine``."""
