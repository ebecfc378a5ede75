"""The plain float32 Mask R-CNN the benchmark judges the program with."""
