"""The yardstick: bounds and peaks, the trace reader, the seeded faces and
the comparisons that decide `correct`."""
