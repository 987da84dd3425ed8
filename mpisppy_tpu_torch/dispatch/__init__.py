# Dispatch helpers of the port (the batch-size bucket ladder).
