"""Process-local instrumentation the serving engine reports into."""
