"""The benchmark's yardstick: traffic, the window, trace reading, peaks."""
