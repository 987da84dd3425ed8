# Scenario data plane of the port: trees and scenario batches.
