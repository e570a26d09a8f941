"""Serving: the continuous-batching LLM engine (`serve.engine`)."""
