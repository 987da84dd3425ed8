# Extension hooks the PH driver calls.
