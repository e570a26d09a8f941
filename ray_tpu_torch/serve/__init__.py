"""Serving: the continuous-batching LLM engine (`serve.engine`) and the
multi-replica fleet over it (`serve.fleet`)."""
