"""Span timing and tracing."""
