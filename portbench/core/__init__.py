"""The harness's yardstick: loading cells by name, seeds, window statistics,
the card's peaks, the trace reduction and the result line."""
